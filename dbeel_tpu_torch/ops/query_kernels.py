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

What bounds them is bytes: 8 B of value and 1 B of validity read per
row, 1 B of mask written (the filters) — at a 1M-row stage about 3 µs
at 3.35 TB/s, the order of one launch.  So each is one pass, one
thread per row, and the reductions take a fixed-shape second pass
instead of atomics (a deterministic sum for a given n).

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


def _check(vals: torch.Tensor, mask: torch.Tensor) -> str:
    if vals.dtype != torch.float64 or mask.dtype != torch.bool:
        raise ValueError("want float64 values and a bool mask")
    if vals.dim() != 1 or vals.shape != mask.shape:
        raise ValueError(
            f"want two 1-D tensors of one length, got "
            f"{tuple(vals.shape)} and {tuple(mask.shape)}"
        )
    if not (vals.is_contiguous() and mask.is_contiguous()):
        raise ValueError("want contiguous tensors")
    if vals.device != mask.device:
        raise ValueError("both operands must lie on one device")
    kind = vals.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {kind}")
    return kind


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


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
    if op not in OPS:
        raise ValueError(f"unknown comparison {op!r}")
    if _check(vals, valid) == "cpu":
        return cmp_f64_plain(vals, valid, operand, op)
    out = torch.empty(vals.shape, dtype=torch.bool, device=vals.device)
    rc = _cuda.query_lib().dbeel_query_cmp_f64(
        vals.data_ptr(), valid.data_ptr(), vals.numel(), float(operand),
        OPS.index(op), out.data_ptr(), _stream(vals),
    )
    _cuda.check(rc, "cmp_f64")
    _cuda.count("K8a")
    return out


def range_f64(vals, valid, lo: float, hi: float,
              use_lo: bool, use_hi: bool) -> torch.Tensor:
    """K8b — replaces dbeel_tpu/ops/query_kernels.py:170 range_f64
    (``hi`` exclusive).  Bound (bytes): 9 B read and 1 B written per
    row."""
    if _check(vals, valid) == "cpu":
        return range_f64_plain(vals, valid, lo, hi, use_lo, use_hi)
    out = torch.empty(vals.shape, dtype=torch.bool, device=vals.device)
    rc = _cuda.query_lib().dbeel_query_range_f64(
        vals.data_ptr(), valid.data_ptr(), vals.numel(), float(lo),
        float(hi), int(bool(use_lo)), int(bool(use_hi)), out.data_ptr(),
        _stream(vals),
    )
    _cuda.check(rc, "range_f64")
    _cuda.count("K8b")
    return out


def sum_f64(vals, mask) -> torch.Tensor:
    """K8c — replaces dbeel_tpu/ops/query_kernels.py:179 sum_f64: a
    0-d float64 tensor.  Bound (bytes): 9 B read per row."""
    if _check(vals, mask) == "cpu":
        return sum_f64_plain(vals, mask)
    lib = _cuda.query_lib()
    n = vals.numel()
    partials = torch.empty(
        lib.dbeel_query_partials(n), dtype=torch.float64, device=vals.device
    )
    out = torch.empty((), dtype=torch.float64, device=vals.device)
    rc = lib.dbeel_query_sum_f64(
        vals.data_ptr(), mask.data_ptr(), n, partials.data_ptr(),
        out.data_ptr(), _stream(vals),
    )
    _cuda.check(rc, "sum_f64")
    _cuda.count("K8c")
    return out


def min_max_f64(vals, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8d — replaces dbeel_tpu/ops/query_kernels.py:183 min_max_f64:
    two 0-d float64 tensors (+inf / -inf for an empty mask).  Bound
    (bytes): 9 B read per row."""
    if _check(vals, mask) == "cpu":
        return min_max_f64_plain(vals, mask)
    lib = _cuda.query_lib()
    n = vals.numel()
    partials = torch.empty(
        2 * lib.dbeel_query_partials(n), dtype=torch.float64,
        device=vals.device,
    )
    out = torch.empty(2, dtype=torch.float64, device=vals.device)
    rc = lib.dbeel_query_min_max_f64(
        vals.data_ptr(), mask.data_ptr(), n, partials.data_ptr(),
        out.data_ptr(), _stream(vals),
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
