"""Query compute plane — the filter/aggregate pushdown spec.

A plain scan ships every live value to the client and makes it filter
there; this module defines the small msgpack expression spec that
moves that compute to where the columns already are (the ScanStage).
It is deliberately dependency-free (no numpy, no torch; MessagePack
through ``utils/msgpack_codec``): clients pack specs through it, a
coordinator validates and plans through it, and the storage fallback
path evaluates entries through the golden per-entry evaluator below —
which is also the byte-identical reference the vectorized evaluator
(storage/query_vec.py) and its filter kernels (ops/query_kernels.py)
are tested against.  A copy of dbeel_tpu/query.py.

Spec grammar (wire form is one packed msgpack list,
``[SPEC_VERSION, where|nil, agg|nil]``):

* predicate tree (``where``)::

      ["and", p1, p2, ...]          all children match
      ["or",  p1, p2, ...]          any child matches
      ["cmp", field, op, operand]   op in ==  !=  <  <=  >  >=
      ["prefix", field, prefix]     byte-prefix test
      ["range", field, lo, hi]      lo <= x < hi (nil = open end)

  ``field`` is ``"$key"`` (the raw msgpack-ENCODED key bytes — the
  storage sort order) or the name of a top-level field of the value
  document.  The OPERAND's type picks the column: int/float operands
  compare numerically, str/bytes operands compare bytewise (str is
  utf-8).  A row whose document is not a map, lacks the field, or
  holds a differently-typed value (bools included) matches NO leaf —
  deterministic and total, never an error.

* aggregate (``agg``)::

      {"op": "count"|"sum"|"min"|"max"|"avg",
       "field": name|nil,           # required unless op == count
       "group": prefix_len|0}       # group by encoded-key prefix

  Aggregates fold only CONTRIBUTING rows (accepted by the predicate
  AND holding a numeric value in ``field``; count folds every
  accepted row).  Partial states combine exactly (see agg_merge):
  arcs are disjoint key ranges, so cross-arc combine is plain
  fold-together; replica overlap WITHIN an arc is resolved before
  folding (newest-wins dedup at the coordinator, or a single live
  stream per arc) — a key never contributes twice.

Exactness rules (pinned by the byte-identical tests): sums keep the
integer part exact (Python int fold) and the float part in
``math.fsum`` — BOTH the golden evaluator and the vectorized kernels
use this decomposition, so their results are equal bytes, not just
approximately equal.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

from .errors import BadFieldType
from .utils import msgpack_codec

# Version tag leading every packed spec.  Lint-pinned three ways
# (analysis/wire_parity.py): this constant (the encoder), scan.py's
# SPEC_WIRE_VERSION (the coordinator parser), and the C client's
# kSpecVersion (dbeel_cli_scan_chunk validates the blob it forwards).
SPEC_VERSION = "q1"

KEY_FIELD = "$key"

CMP_OPS = ("==", "!=", "<", "<=", ">", ">=")
AGG_OPS = ("count", "sum", "min", "max", "avg")

# Guardrails: a peer-supplied spec sizes work, so it must not become
# a CPU/alloc lever on the network-facing port.
MAX_SPEC_BYTES = 16 << 10
MAX_NODES = 64
MAX_DEPTH = 8
MAX_GROUPS = 65536
MAX_GROUP_PREFIX = 128


# ---------------------------------------------------------------------
# Validation / normalization
# ---------------------------------------------------------------------


def _norm_bytes(v: Any, what: str) -> bytes:
    if isinstance(v, str):
        return v.encode("utf-8")
    if isinstance(v, (bytes, bytearray, memoryview)):
        return bytes(v)
    raise BadFieldType(f"spec: {what} must be str/bytes")


def _validate_field(f: Any) -> str:
    if not isinstance(f, str) or not f:
        raise BadFieldType("spec: field must be a non-empty string")
    return f


def validate_where(tree: Any, _depth: int = 0, _count=None) -> list:
    """Normalize + validate one predicate tree (tuples become lists,
    str operands for the key/prefix stay typed, byte-ish operands
    become bytes).  Raises BadFieldType on any malformed or
    unsupported shape — a clean, classified wire error, never a shard
    death."""
    if _count is None:
        _count = [0]
    _count[0] += 1
    if _count[0] > MAX_NODES:
        raise BadFieldType("spec: too many predicate nodes")
    if _depth > MAX_DEPTH:
        raise BadFieldType("spec: predicate tree too deep")
    if not isinstance(tree, (list, tuple)) or not tree:
        raise BadFieldType("spec: predicate must be a non-empty list")
    kind = tree[0]
    if kind in ("and", "or"):
        if len(tree) < 2:
            raise BadFieldType(f"spec: {kind} needs children")
        return [kind] + [
            validate_where(c, _depth + 1, _count) for c in tree[1:]
        ]
    if kind == "cmp":
        if len(tree) != 4:
            raise BadFieldType("spec: cmp takes (field, op, operand)")
        field = _validate_field(tree[1])
        op = tree[2]
        if op not in CMP_OPS:
            raise BadFieldType(f"spec: unsupported cmp op {op!r}")
        operand = tree[3]
        if field == KEY_FIELD:
            operand = _norm_bytes(operand, "$key operand")
        elif isinstance(operand, bool) or not isinstance(
            operand, (int, float, str, bytes, bytearray, memoryview)
        ):
            raise BadFieldType(
                "spec: cmp operand must be int/float/str/bytes"
            )
        elif isinstance(operand, (bytes, bytearray, memoryview)):
            operand = bytes(operand)
        return ["cmp", field, op, operand]
    if kind == "prefix":
        if len(tree) != 3:
            raise BadFieldType("spec: prefix takes (field, prefix)")
        field = _validate_field(tree[1])
        return ["prefix", field, _norm_bytes(tree[2], "prefix")]
    if kind == "range":
        if len(tree) != 4:
            raise BadFieldType("spec: range takes (field, lo, hi)")
        field = _validate_field(tree[1])
        lo, hi = tree[2], tree[3]
        out = ["range", field]
        for name, bound in (("lo", lo), ("hi", hi)):
            if bound is None:
                out.append(None)
            elif field == KEY_FIELD or isinstance(
                bound, (str, bytes, bytearray, memoryview)
            ):
                out.append(_norm_bytes(bound, f"range {name}"))
            elif isinstance(bound, bool) or not isinstance(
                bound, (int, float)
            ):
                raise BadFieldType(
                    "spec: range bound must be numeric/str/bytes"
                )
            else:
                out.append(bound)
        if (
            out[2] is not None
            and out[3] is not None
            and type(out[2]) is not type(out[3])
            and not (
                isinstance(out[2], (int, float))
                and isinstance(out[3], (int, float))
            )
        ):
            raise BadFieldType("spec: range bounds of mixed kind")
        return out
    raise BadFieldType(f"spec: unknown predicate kind {kind!r}")


def validate_agg(agg: Any) -> dict:
    if not isinstance(agg, dict):
        raise BadFieldType("spec: aggregate must be a map")
    op = agg.get("op")
    if op not in AGG_OPS:
        raise BadFieldType(f"spec: unsupported aggregate op {op!r}")
    field = agg.get("field")
    if op == "count":
        field = None
    elif not isinstance(field, str) or not field:
        raise BadFieldType(f"spec: aggregate {op!r} needs a field")
    group = agg.get("group") or 0
    if (
        isinstance(group, bool)
        or not isinstance(group, int)
        or group < 0
        or group > MAX_GROUP_PREFIX
    ):
        raise BadFieldType("spec: group must be a small prefix length")
    return {"op": op, "field": field, "group": int(group)}


def build_spec(
    where: Any = None, aggregate: Any = None
) -> Tuple[Optional[list], Optional[dict]]:
    """Client-side entry: validate the user's filter/aggregate into
    the normalized (where, agg) pair pack_spec encodes."""
    w = validate_where(where) if where is not None else None
    a = validate_agg(aggregate) if aggregate is not None else None
    if w is None and a is None:
        raise BadFieldType("spec: empty (no filter, no aggregate)")
    return w, a


def pack_spec(where: Optional[list], agg: Optional[dict]) -> bytes:
    return msgpack_codec.packb([SPEC_VERSION, where, agg])


def unpack_spec(raw: Any) -> Tuple[Optional[list], Optional[dict]]:
    """Decode + re-validate one packed spec (the coordinator runs
    this on every scan/scan_next frame that carries one: specs arrive
    from the network and from resumed cursors, so nothing about them
    is trusted)."""
    if not isinstance(raw, (bytes, bytearray, memoryview)):
        raise BadFieldType("spec: expected packed bytes")
    if len(raw) > MAX_SPEC_BYTES:
        raise BadFieldType("spec: too large")
    try:
        w = msgpack_codec.unpackb(raw)
    except Exception as e:
        raise BadFieldType(f"spec: undecodable ({e})") from e
    if (
        not isinstance(w, (list, tuple))
        or len(w) != 3
        or w[0] != SPEC_VERSION
    ):
        raise BadFieldType("spec: unknown version or shape")
    where = validate_where(w[1]) if w[1] is not None else None
    agg = validate_agg(w[2]) if w[2] is not None else None
    if where is None and agg is None:
        raise BadFieldType("spec: empty (no filter, no aggregate)")
    return where, agg


# Peer-frame spec: the coordinator re-packs (where, agg, mode) per
# arc fetch.  mode "drop" = one live stream covers the arc, the
# replica's newest-per-key IS the winner: non-matching rows (and
# tombstones) never cross the wire, and aggregates return per-page
# partials.  mode "mark" = replicated arc under possible divergence:
# the replica returns its newest-per-key rows as
# [key, payload, ts, flag] with values/field payloads ONLY on
# matches — the coordinator dedups newest-wins across the arc's
# streams and accepts a key iff the WINNER matched (a newer
# tombstone or newer non-matching version suppresses an older
# match).
MODE_DROP = "drop"
MODE_MARK = "mark"


def pack_peer_spec(
    where: Optional[list], agg: Optional[dict], mode: str
) -> bytes:
    return msgpack_codec.packb([SPEC_VERSION, where, agg, mode])


def unpack_peer_spec(
    raw: Any,
) -> Tuple[Optional[list], Optional[dict], str]:
    if not isinstance(raw, (bytes, bytearray, memoryview)):
        raise BadFieldType("peer spec: expected packed bytes")
    if len(raw) > MAX_SPEC_BYTES:
        raise BadFieldType("peer spec: too large")
    try:
        w = msgpack_codec.unpackb(raw)
    except Exception as e:
        raise BadFieldType(f"peer spec: undecodable ({e})") from e
    if (
        not isinstance(w, (list, tuple))
        or len(w) != 4
        or w[0] != SPEC_VERSION
        or w[3] not in (MODE_DROP, MODE_MARK)
    ):
        raise BadFieldType("peer spec: unknown version or shape")
    where = validate_where(w[1]) if w[1] is not None else None
    agg = validate_agg(w[2]) if w[2] is not None else None
    return where, agg, w[3]


# ---------------------------------------------------------------------
# Golden per-entry evaluator (the byte-identical reference)
# ---------------------------------------------------------------------


def spec_fields(
    where: Optional[list], agg: Optional[dict]
) -> set:
    """Value-document field names the spec touches (the columns the
    vectorized evaluator must build)."""
    out: set = set()

    def walk(node):
        if node[0] in ("and", "or"):
            for c in node[1:]:
                walk(c)
        elif node[1] != KEY_FIELD:
            out.add(node[1])

    if where is not None:
        walk(where)
    if agg is not None and agg.get("field"):
        out.add(agg["field"])
    return out


def increment_prefix(prefix: bytes) -> Optional[bytes]:
    """Smallest byte string greater than every string with
    ``prefix`` (None when the prefix is all 0xff)."""
    b = bytearray(prefix)
    while b:
        if b[-1] != 0xFF:
            b[-1] += 1
            return bytes(b)
        b.pop()
    return None


def decode_doc(value: Any) -> Optional[dict]:
    """The value document as a map, or None (undecodable / not a
    map / tombstone): rows without a map document match no field
    leaf."""
    if value is None or len(value) == 0:
        return None
    try:
        doc = msgpack_codec.unpackb(value)
    except Exception:
        return None
    return doc if isinstance(doc, dict) else None


def field_value(doc: Optional[dict], name: str) -> Any:
    """The typed field value a leaf tests, or None when the row
    cannot match ANY leaf on this field: missing field, bool (never
    comparable — Python's bool/int aliasing would make ``True == 1``
    match surprisingly), or a non-scalar."""
    if doc is None:
        return None
    v = doc.get(name)
    if isinstance(v, bool) or v is None:
        return None
    if isinstance(v, (int, float, str, bytes)):
        return v
    return None


def _leaf_cmp(x: Any, op: str, operand: Any) -> bool:
    if isinstance(operand, (int, float)):
        if not isinstance(x, (int, float)):
            return False
    else:  # bytes/str leaf: compare bytewise
        if not isinstance(x, (str, bytes)):
            return False
        x = x.encode("utf-8") if isinstance(x, str) else x
        operand = (
            operand.encode("utf-8")
            if isinstance(operand, str)
            else operand
        )
    if op == "==":
        return x == operand
    if op == "!=":
        return x != operand
    if op == "<":
        return x < operand
    if op == "<=":
        return x <= operand
    if op == ">":
        return x > operand
    return x >= operand


def _leaf_value(
    where: list, key: bytes, doc: Optional[dict]
) -> Any:
    field = where[1]
    if field == KEY_FIELD:
        return key
    return field_value(doc, field)


def match_entry(
    where: Optional[list], key: bytes, value: Any
) -> bool:
    """Golden evaluator: does (key, value-bytes) satisfy the tree?
    Tombstones (empty value) match nothing — they are suppressors,
    handled by the merge, not by the filter."""
    if where is None:
        return value is not None and len(value) != 0
    if value is None or len(value) == 0:
        return False
    return _match(where, bytes(key), decode_doc(value))


def _match(where: list, key: bytes, doc: Optional[dict]) -> bool:
    kind = where[0]
    if kind == "and":
        return all(_match(c, key, doc) for c in where[1:])
    if kind == "or":
        return any(_match(c, key, doc) for c in where[1:])
    if kind == "cmp":
        x = _leaf_value(where, key, doc)
        if x is None:
            return False
        return _leaf_cmp(x, where[2], where[3])
    if kind == "prefix":
        x = _leaf_value(where, key, doc)
        if x is None or isinstance(x, (int, float)):
            return False
        xb = x.encode("utf-8") if isinstance(x, str) else x
        return xb.startswith(where[2])
    # range: lo <= x < hi
    x = _leaf_value(where, key, doc)
    if x is None:
        return False
    lo, hi = where[2], where[3]
    num_bounds = isinstance(lo, (int, float)) or isinstance(
        hi, (int, float)
    )
    if isinstance(x, (int, float)) != num_bounds and not (
        lo is None and hi is None
    ):
        return False
    if not isinstance(x, (int, float)):
        x = x.encode("utf-8") if isinstance(x, str) else x
    if lo is not None and not (lo <= x):
        return False
    if hi is not None and not (x < hi):
        return False
    return True


# ---------------------------------------------------------------------
# Aggregate partial states + exact combine rules
# ---------------------------------------------------------------------
#
# State is wire/cursor-safe msgpack: ungrouped ``[n, isum,
# fpartials, mn, mx]`` where n counts contributing rows, isum is the
# exact integer part (Python int, unbounded), and fpartials is the
# float part as EXACT non-overlapping Shewchuk partials (the same
# representation math.fsum keeps internally): every float fold and
# every merge is exact, so the sum is order-independent by
# construction and rounds exactly ONCE, at result time — the
# vectorized kernels, the golden walk, per-arc partial combine, and
# cursor resume all produce the same bytes no matter the fold
# order.  Grouped: {group_key_bytes: state}.
#
# min/max keep the FIRST-seen achiever on exact ties (``x < mn``
# strict) — order-dependent only across int/float ties of equal
# value, which the vectorized reducer reproduces by position.


def grow_partials(partials: list, x: float) -> None:
    """Shewchuk exact accumulation: after the fold,
    ``sum(partials)`` is EXACTLY the previous exact sum plus x, with
    the terms non-overlapping (so the list stays short).  This is
    fsum's inner loop, exposed so partial states can travel the
    wire mid-sum without losing the residue."""
    i = 0
    for y in partials:
        if abs(x) < abs(y):
            x, y = y, x
        hi = x + y
        lo = y - (hi - x)
        if lo:
            partials[i] = lo
            i += 1
        x = hi
    partials[i:] = [x]


def agg_new() -> list:
    return [0, 0, [], None, None]


def agg_fold(state: list, op: str, x: Any) -> None:
    """Fold one contributing value (count folds x=None)."""
    state[0] += 1
    if op == "count" or x is None:
        return
    if op in ("sum", "avg"):
        if isinstance(x, int):
            state[1] += x
        else:
            grow_partials(state[2], float(x))
    if op in ("min", "max", "sum", "avg"):
        mn, mx = state[3], state[4]
        state[3] = x if mn is None or x < mn else mn
        state[4] = x if mx is None or x > mx else mx


def agg_merge(dst: list, src: list) -> None:
    """Combine two partial states (per-arc partials, cursor resume):
    exact — int parts add, float partials fold exactly, min/max fold
    with nil as identity."""
    dst[0] += src[0]
    dst[1] += src[1]
    for term in src[2]:
        grow_partials(dst[2], float(term))
    for i, pick in ((3, min), (4, max)):
        if src[i] is not None:
            dst[i] = (
                src[i]
                if dst[i] is None
                else pick(dst[i], src[i])
            )


def agg_result(state: list, op: str) -> Any:
    n, isum, fl, mn, mx = state
    if op == "count":
        return n
    if n == 0:
        return None
    if op == "min":
        return mn
    if op == "max":
        return mx
    total = isum + math.fsum(fl) if fl else isum
    if op == "sum":
        return total
    return total / n  # avg


def agg_state_copy(st: Any) -> list:
    """Deep-enough copy of one wire state (the float partial list is
    the only mutable member)."""
    return [st[0], st[1], list(st[2]), st[3], st[4]]


def contributes(op: str, x: Any) -> bool:
    """Does field value x contribute to the aggregate?  count takes
    every accepted row; numeric aggregates take numeric values
    only."""
    if op == "count":
        return True
    return isinstance(x, (int, float)) and not isinstance(x, bool)


class AggState:
    """Coordinator-side accumulator: grouped or not, folds accepted
    rows and per-arc partials, round-trips through the cursor."""

    __slots__ = ("agg", "groups", "flat")

    def __init__(self, agg: dict) -> None:
        self.agg = agg
        self.groups: Optional[dict] = (
            {} if agg["group"] else None
        )
        self.flat = agg_new()

    def _state_for(self, key: bytes) -> list:
        if self.groups is None:
            return self.flat
        g = bytes(key[: self.agg["group"]])
        st = self.groups.get(g)
        if st is None:
            if len(self.groups) >= MAX_GROUPS:
                raise BadFieldType(
                    "spec: aggregate group cardinality too high"
                )
            st = self.groups[g] = agg_new()
        return st

    def fold_row(self, key: bytes, x: Any) -> None:
        op = self.agg["op"]
        if not contributes(op, x):
            return
        agg_fold(
            self._state_for(key), op, None if op == "count" else x
        )

    def fold_partial(self, partial: Any) -> None:
        """One replica page's partial: ungrouped state list, or a
        [group_key, state] pair list."""
        if partial is None:
            return
        if self.groups is None:
            self._check_state(partial)
            agg_merge(self.flat, list(partial))
            return
        if not isinstance(partial, (list, tuple)):
            raise BadFieldType("spec: malformed aggregate partial")
        for pair in partial:
            if (
                not isinstance(pair, (list, tuple))
                or len(pair) != 2
            ):
                raise BadFieldType(
                    "spec: malformed aggregate partial"
                )
            g = bytes(pair[0])
            self._check_state(pair[1])
            st = self.groups.get(g)
            if st is None:
                if len(self.groups) >= MAX_GROUPS:
                    raise BadFieldType(
                        "spec: aggregate group cardinality too high"
                    )
                self.groups[g] = agg_state_copy(pair[1])
            else:
                agg_merge(st, list(pair[1]))

    @staticmethod
    def _check_state(st: Any) -> None:
        # Wire states are untrusted (they ride client-held cursors):
        # n and the int lane must be exact ints, float terms floats,
        # and min/max NUMERIC or nil — contributes() only ever folds
        # numerics, so anything else is a crafted state that would
        # TypeError inside a later fold.
        if (
            not isinstance(st, (list, tuple))
            or len(st) != 5
            or isinstance(st[0], bool)
            or not isinstance(st[0], int)
            or isinstance(st[1], bool)
            or not isinstance(st[1], int)
            or not isinstance(st[2], (list, tuple))
            or not all(
                isinstance(t, (int, float))
                and not isinstance(t, bool)
                for t in st[2]
            )
            or not all(
                st[i] is None
                or (
                    isinstance(st[i], (int, float))
                    and not isinstance(st[i], bool)
                )
                for i in (3, 4)
            )
        ):
            raise BadFieldType("spec: malformed aggregate state")

    # -- cursor round trip --------------------------------------------

    def to_wire(self) -> list:
        if self.groups is None:
            return [0, self.flat]
        return [1, [[g, st] for g, st in self.groups.items()]]

    @classmethod
    def from_wire(cls, agg: dict, wire: Any) -> "AggState":
        self = cls(agg)
        if wire is None:
            return self
        if not isinstance(wire, (list, tuple)) or len(wire) != 2:
            raise BadFieldType("spec: malformed aggregate cursor")
        grouped, payload = wire
        if bool(grouped) != (self.groups is not None):
            raise BadFieldType("spec: aggregate cursor shape drift")
        if self.groups is None:
            self._check_state(payload)
            self.flat = agg_state_copy(payload)
        else:
            self.fold_partial(payload)
        return self

    def result(self) -> Any:
        op = self.agg["op"]
        if self.groups is None:
            return agg_result(self.flat, op)
        return {
            g: agg_result(st, op)
            for g, st in sorted(self.groups.items())
        }
