"""K8 — the query plane's float64 filter and aggregate kernels on the card.

The scan plane's pushdown evaluator (storage/query_vec.py) evaluates
every numeric leaf of a predicate over a staged float64 column.  At
``MIN_DEVICE_ROWS`` rows and more that leaf runs here; below it the
host numpy lane serves, as in dbeel_tpu (a size rule: a launch and two
copies cost more than numpy over a few thousand rows).  The kernels
(``csrc/query.cu``) replace the jitted twins of
dbeel_tpu/ops/query_kernels.py ``_kernels`` (:144):

  K8a cmp_f64     (:154, wrapper eval_cmp_f64 :197) — ``(vals OP
      operand) & valid``, OP one of == != < <= > >=
  K8b range_f64   (:170, eval_range_f64 :219) — ``valid & (!use_lo |
      vals >= lo) & (!use_hi | vals < hi)``
  K8c sum_f64     (:179) — ``sum(where(mask, vals, 0))``
  K8d min_max_f64 (:183) — ``(min(where(mask, vals, +inf)),
      max(where(mask, vals, -inf)))``, a masked-in NaN propagating

What bounds them on the card is bytes: 8 B of value and 1 B of
validity read per row, 1 B of mask written (the filters) — at a 1M-row
stage about 3 µs at 3.35 TB/s, the order of one launch.  So each is
one pass.  K8a and K8c take four rows per thread (16 B value loads,
4 B mask loads and stores; a scalar path for views off that
alignment), and K8c and K8d are one launch each: each block's partial,
then the last block to take a ticket reduces the partials in index
order (a reduction whose order, and so whose bits, depend on n alone).
K8b keeps one row per thread.  K8d takes four rows per thread as K8c
does.  ``csrc/query.cu`` describes the kernels.

What bounds a call is mostly the host: at these sizes the device work
is a few µs, less than the Python around a ctypes launch costs.  So
the launch path is kept short: ``_bind`` resolves the library's
functions (and the torch handles a launch needs) once, at first use,
and later calls find them without a lock; each call makes its operand
checks in one
pass (``_check``), allocates its output, reads the launching thread's
current stream as a raw handle (no ``torch.cuda.Stream`` object), makes
one ctypes call and counts the launch.  K8c's and K8d's scratch
(partials and ticket) is allocated zeroed once per (card, stream) and
reused, so two threads launching on two streams never share a ticket.

Exactness: the mask is bit-equal to numpy's float64 comparison (IEEE:
NaN != x is true, every other comparison with NaN false, -0.0 == 0.0);
the byte lanes and the exact-int fix-up rows stay on the host
evaluator.  min/max follow XLA: NaN propagates, -0.0 orders below 0.0.

Each kernel wrapper takes tensors: for a CUDA tensor it launches the
kernel (or raises), for a CPU tensor it runs the plain PyTorch version.
``eval_*`` are the host entries the evaluator calls: numpy columns go
up per evaluation (pageable copies on the launching thread's current
stream), the result comes back to numpy on that stream before it is
returned.  ``device`` is ``cuda`` unless the caller names ``cpu``;
there is no host fallback behind a failed build or launch — it raises.
The first CUDA launch of the process is recorded by ``_persist_wake``.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from . import _cuda

log = logging.getLogger(__name__)

OPS = ("==", "!=", "<", "<=", ">", ">=")

# Below this many rows the host numpy lane serves the leaf.
MIN_DEVICE_ROWS = 4096

_INF = float("inf")


_F64, _BOOL = torch.float64, torch.bool
_OP_CODE = {op: i for i, op in enumerate(OPS)}


def _check(vals: torch.Tensor, mask: torch.Tensor) -> int:
    """The operands' card index, or -1 for CPU tensors; raises
    ValueError unless both are contiguous 1-D tensors of one length on
    one device, float64 values and a bool mask — one pass of cheap
    tests, since a kernel call's time is mostly the host's."""
    idx = vals.get_device()
    if (
        vals.dtype is _F64 and mask.dtype is _BOOL
        and vals.dim() == 1 and vals.shape == mask.shape
        and vals.is_contiguous() and mask.is_contiguous()
        and mask.get_device() == idx
        and (idx >= 0 or (vals.is_cpu and mask.is_cpu))
    ):
        return idx
    got = " and ".join(
        f"{t.dtype} {tuple(t.shape)} strides {t.stride()} on {t.device}"
        for t in (vals, mask)
    )
    raise ValueError(
        "want contiguous 1-D float64 values and a bool mask of one length "
        f"on one cpu or cuda device, got {got}"
    )


class _Bound:
    """The library's entries and the torch handles a launch needs,
    resolved once (``_bind``)."""

    __slots__ = ("cmp", "range", "sum", "min_max", "sum_scratch",
                 "min_max_scratch", "stream", "current")

    def __init__(self, handle):
        self.cmp = handle.dbeel_query_cmp_f64
        self.range = handle.dbeel_query_range_f64
        self.sum = handle.dbeel_query_sum_f64
        self.min_max = handle.dbeel_query_min_max_f64
        self.sum_scratch = handle.dbeel_query_sum_scratch()
        self.min_max_scratch = handle.dbeel_query_min_max_scratch()
        # The launching thread's current stream on card i as a raw
        # handle (no torch.cuda.Stream object), and its current card:
        # always 0 where only one card is visible.
        self.stream = torch._C._cuda_getCurrentRawStream
        self.current = (
            torch._C._cuda_getDevice if torch.cuda.device_count() > 1
            else lambda: 0
        )


_bound: Optional[_Bound] = None
# K8c's and K8d's scratch by (card, stream handle): partials and a
# ticket, zeroed once; the kernel leaves the ticket at zero.
_sum_scratch: dict = {}
_min_max_scratch: dict = {}


def _scratch(store: dict, idx: int, stream: int, doubles: int,
             device) -> torch.Tensor:
    """The scratch of (card, stream) in ``store``, allocated and zeroed
    on that stream before its first launch."""
    scratch = store.get((idx, stream))
    if scratch is None:
        scratch = store.setdefault(
            (idx, stream), torch.zeros(doubles, dtype=_F64, device=device)
        )
    return scratch


def _bind() -> _Bound:
    """Builds and binds ``csrc/query.cu`` at first use; later launches
    read the module global and take no lock."""
    global _bound
    if _bound is None:
        _bound = _Bound(_cuda.query_lib())
    return _bound


# ----------------------------------------------------------------------
# Plain PyTorch versions (the tests, device="cpu", and chip_smoke.py's
# comparison on the card)
# ----------------------------------------------------------------------


def cmp_f64_plain(vals, valid, operand: float, op: str) -> torch.Tensor:
    if op not in OPS:
        raise ValueError(f"unknown comparison {op!r}")
    fn = {
        "==": torch.eq, "!=": torch.ne, "<": torch.lt,
        "<=": torch.le, ">": torch.gt, ">=": torch.ge,
    }[op]
    return fn(vals, float(operand)) & valid


def range_f64_plain(vals, valid, lo: float, hi: float,
                    use_lo: bool, use_hi: bool) -> torch.Tensor:
    m = valid.clone()
    if use_lo:
        m &= vals >= float(lo)
    if use_hi:
        m &= vals < float(hi)
    return m


def sum_f64_plain(vals, mask) -> torch.Tensor:
    return torch.where(mask, vals, 0.0).sum()


def min_max_f64_plain(vals, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    if vals.numel() == 0:
        return (
            torch.tensor(_INF, dtype=torch.float64, device=vals.device),
            torch.tensor(-_INF, dtype=torch.float64, device=vals.device),
        )
    mn = torch.where(mask, vals, _INF).amin()
    mx = torch.where(mask, vals, -_INF).amax()
    # XLA's min/max order -0.0 below 0.0; amin/amax keep either zero.
    zero = mask & (vals == 0)
    neg = torch.signbit(vals)
    neg_zero, pos_zero = vals.new_tensor(-0.0), vals.new_tensor(0.0)
    mn = torch.where(
        mn == 0, torch.where((zero & neg).any(), neg_zero, pos_zero), mn
    )
    mx = torch.where(
        mx == 0, torch.where((zero & ~neg).any(), pos_zero, neg_zero), mx
    )
    return mn, mx


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------


def cmp_f64(vals, valid, operand: float, op: str) -> torch.Tensor:
    """K8a — replaces dbeel_tpu/ops/query_kernels.py:154 cmp_f64.
    Bound (bytes): 9 B read and 1 B written per row."""
    code = _OP_CODE.get(op)
    if code is None:
        raise ValueError(f"unknown comparison {op!r}")
    idx = _check(vals, valid)
    if idx < 0:
        return cmp_f64_plain(vals, valid, operand, op)
    b = _bound or _bind()
    if b.current() != idx:
        with torch.cuda.device(idx):
            return cmp_f64(vals, valid, operand, op)
    out = torch.empty_like(valid)
    rc = b.cmp(
        vals.data_ptr(), valid.data_ptr(), vals.numel(), float(operand), code,
        out.data_ptr(), b.stream(idx),
    )
    _cuda.check(rc, "cmp_f64")
    _cuda.count("K8a")
    return out


def range_f64(vals, valid, lo: float, hi: float,
              use_lo: bool, use_hi: bool) -> torch.Tensor:
    """K8b — replaces dbeel_tpu/ops/query_kernels.py:170 range_f64
    (``hi`` exclusive).  Bound (bytes): 9 B read and 1 B written per
    row."""
    idx = _check(vals, valid)
    if idx < 0:
        return range_f64_plain(vals, valid, lo, hi, use_lo, use_hi)
    b = _bound or _bind()
    if b.current() != idx:
        with torch.cuda.device(idx):
            return range_f64(vals, valid, lo, hi, use_lo, use_hi)
    out = torch.empty_like(valid)
    rc = b.range(
        vals.data_ptr(), valid.data_ptr(), vals.numel(), float(lo), float(hi),
        int(bool(use_lo)), int(bool(use_hi)), out.data_ptr(), b.stream(idx),
    )
    _cuda.check(rc, "range_f64")
    _cuda.count("K8b")
    return out


def sum_f64(vals, mask) -> torch.Tensor:
    """K8c — replaces dbeel_tpu/ops/query_kernels.py:179 sum_f64: a
    0-d float64 tensor, its bits a function of the inputs alone (the
    order of the sum depends on n only).  Bound (bytes): 9 B read per
    row."""
    idx = _check(vals, mask)
    if idx < 0:
        return sum_f64_plain(vals, mask)
    b = _bound or _bind()
    if b.current() != idx:
        with torch.cuda.device(idx):
            return sum_f64(vals, mask)
    stream = b.stream(idx)
    scratch = _scratch(_sum_scratch, idx, stream, b.sum_scratch, vals.device)
    out = torch.empty((), dtype=_F64, device=vals.device)
    rc = b.sum(
        vals.data_ptr(), mask.data_ptr(), vals.numel(), scratch.data_ptr(),
        out.data_ptr(), stream,
    )
    _cuda.check(rc, "sum_f64")
    _cuda.count("K8c")
    return out


def min_max_f64(vals, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8d — replaces dbeel_tpu/ops/query_kernels.py:183 min_max_f64:
    two 0-d float64 tensors (+inf / -inf for an empty mask), one launch
    whose bits depend on the inputs alone.  A masked-in NaN makes both
    results NaN; where the masked-in NaNs differ in their bits, which
    NaN comes back is not specified (the kernel returns one of them, and
    ``min_max_f64_plain`` what ``amin``/``amax`` give).  Bound (bytes):
    9 B read per row."""
    idx = _check(vals, mask)
    if idx < 0:
        return min_max_f64_plain(vals, mask)
    b = _bound or _bind()
    if b.current() != idx:
        with torch.cuda.device(idx):
            return min_max_f64(vals, mask)
    stream = b.stream(idx)
    scratch = _scratch(
        _min_max_scratch, idx, stream, b.min_max_scratch, vals.device
    )
    out = torch.empty(2, dtype=_F64, device=vals.device)
    rc = b.min_max(
        vals.data_ptr(), mask.data_ptr(), vals.numel(), scratch.data_ptr(),
        out.data_ptr(), stream,
    )
    _cuda.check(rc, "min_max_f64")
    _cuda.count("K8d")
    return out[0], out[1]


# ----------------------------------------------------------------------
# Host entries: numpy columns in, numpy/Python results out
# ----------------------------------------------------------------------


def _up(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t if dev.type == "cpu" else t.to(dev)


def eval_cmp_f64(vals: np.ndarray, valid: np.ndarray, operand: float,
                 op: str, device=None) -> Optional[np.ndarray]:
    """The float64 comparison leaf through K8a, or None below
    ``MIN_DEVICE_ROWS`` rows (the caller's numpy lane serves)."""
    if vals.size < MIN_DEVICE_ROWS:
        return None
    dev = _cuda.resolve_device(device)
    out = cmp_f64(_up(vals, dev), _up(valid, dev), operand, op)
    mask = out.cpu().numpy()
    _persist_wake(dev, "query_filter", rows=int(vals.size),
                  kernels="K8a cmp_f64")
    return mask


def eval_range_f64(vals: np.ndarray, valid: np.ndarray,
                   lo: Optional[float], hi: Optional[float],
                   device=None) -> Optional[np.ndarray]:
    """The float64 range leaf (``lo <= x < hi``, None = open end)
    through K8b, or None below ``MIN_DEVICE_ROWS`` rows."""
    if vals.size < MIN_DEVICE_ROWS:
        return None
    dev = _cuda.resolve_device(device)
    out = range_f64(
        _up(vals, dev), _up(valid, dev),
        0.0 if lo is None else lo, 0.0 if hi is None else hi,
        lo is not None, hi is not None,
    )
    mask = out.cpu().numpy()
    _persist_wake(dev, "query_filter", rows=int(vals.size),
                  kernels="K8b range_f64")
    return mask


def eval_sum_f64(vals: np.ndarray, mask: np.ndarray, device=None) -> float:
    """``sum(where(mask, vals, 0))`` through K8c."""
    dev = _cuda.resolve_device(device)
    return float(sum_f64(_up(vals, dev), _up(mask, dev)).item())


def eval_min_max_f64(vals: np.ndarray, mask: np.ndarray,
                     device=None) -> Tuple[float, float]:
    """``(min, max)`` over the masked rows through K8d."""
    dev = _cuda.resolve_device(device)
    mn, mx = min_max_f64(_up(vals, dev), _up(mask, dev))
    return float(mn.item()), float(mx.item())


# ----------------------------------------------------------------------
# First CUDA launch of the process: a provenance record
# ----------------------------------------------------------------------

_persisted: set = set()
_persist_lock = threading.Lock()


def last_good_path() -> str:
    """``DBEEL_DEVICE_LAST_GOOD`` if set, else DEVICE_LAST_GOOD.json in
    the package's build directory (listed in .gitignore)."""
    override = os.environ.get("DBEEL_DEVICE_LAST_GOOD")
    if override:
        return override
    return os.path.join(_cuda.BUILD_DIR, "DEVICE_LAST_GOOD.json")


def _persist_wake(dev: torch.device, section: str, **facts) -> None:
    """Record, once per ``section`` and process, the first CUDA launch
    of a device plane (``query_filter`` here, ``coalesced_compaction``
    from the coalescer): the card's name and the launch's facts, merged
    into the JSON file at ``last_good_path()``.  Plain versions never
    write it.  The record is provenance, not serving state: a failed
    write is logged and the launch's result stands."""
    if dev.type != "cuda":
        return
    with _persist_lock:
        if section in _persisted:
            return
        _persisted.add(section)
    import fcntl

    path = last_good_path()
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path + ".lock", "w") as lock_f:
            fcntl.flock(lock_f, fcntl.LOCK_EX)
            try:
                with open(path) as f:
                    data = json.load(f)
            except (OSError, ValueError):
                data = {}
            if not isinstance(data, dict):
                data = {}
            data[section] = {
                "timestamp_utc": time.strftime(
                    "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
                ),
                "platform": "gpu",
                "device": torch.cuda.get_device_name(dev),
                **facts,
            }
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(data, f, indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, path)
    except OSError as e:
        log.warning("DEVICE_LAST_GOOD record not written: %s", e)
