"""Device sort + dedup kernel for compaction (K7).

The counterpart of ``dbeel_tpu/ops/merge.py``: the k-way merge over K
sorted runs recast as ONE lexicographic sort over the concatenation of
all runs, followed by an adjacent-equality pass that marks every later
copy of a key.  In ``dbeel_tpu`` the sort is XLA's own ``lax.sort``
(``_sort_kernel`` :35) and the pass ``_same_key_mask`` (:42); here both
are one hand-written CUDA entry, ``dbeel_bitonic_sort_dedup_cols`` in
``csrc/bitonic.cu``: the 8-word bitonic network with one-row runs on
K5's schedule (``k5_merge_rows``, P = 1; 19 launches at 2^19 rows),
whose first launch reads the nine columns into rows in shared memory
and whose last writes the sorted rows back as columns with the
5-column ``same`` flags.

Sort key tuple, ascending (all u32):
    k0..k3   big-endian words of the 16-byte key prefix
    key_len  (shorter keys first among shared-prefix keys)
    ~ts_hi, ~ts_lo   bitwise-inverted split timestamp → newest first
    ~src     → newer input sstable first on timestamp ties
and the row index carried as the ninth operand.  Shapes are padded to
the next power of two (at least 8) with ``U32_MAX`` in every operand;
that padding sorts strictly last (no real key length reaches it).

``lax.sort`` is unstable, so the reference leaves the order of rows
that tie on all 8 keys unspecified; the network here is deterministic
and its plain version (``sort_dedup_plain``: the same network, stage
for stage) bit-equal to it.  Such ties need keys longer than the
16-byte prefix, which the callers re-order on the host
(``columnar.fixup_long_key_ties``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..storage import columnar
from . import _cuda
from .bitonic import (
    NUM_COLS,
    NUM_KEY_COLS,
    _check,
    _device_kind,
    _from_u64,
    _merge_plain,
    _pow2,
    _stream,
    _u64,
    to_tensor,
)

_U32_MAX = np.uint32(0xFFFFFFFF)


def _pad_to_pow2(n: int) -> int:
    return max(_pow2(n), 8)


def sort_dedup_plain(cols: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's plain version: (9, N) columns → the columns sorted on the
    first 8 (as one-row runs through the bitonic network, in int64) and
    same[i] = columns 0-4 of row i equal those of row i-1."""
    rows = _u64(cols).t()
    out = _merge_plain(rows[None, :, None, :], NUM_KEY_COLS)[0]
    eq = torch.ones(out.shape[0] - 1, dtype=torch.bool, device=out.device)
    for c in range(5):
        eq = eq & (out[1:, c] == out[:-1, c])
    same = torch.cat([torch.zeros(1, dtype=torch.bool, device=out.device), eq])
    return _from_u64(out.t().contiguous()), same


def sort_dedup_kernel(
    cols: torch.Tensor,  # (9, N) u32 bits, N a power of two >= 8
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7 — replaces dbeel_tpu/ops/merge.py:35 _sort_kernel (lax.sort of
    9 operands on 8 keys) and :42 _same_key_mask: the sorted (9, N)
    columns and the same-key flags (N,) bool.  On the card K5's
    schedule with a column prologue and epilogue, 1 + 2 log2(N / 1024)
    launches up to N = 2^19 (csrc/bitonic.cu).  Bound (bytes): the
    columns read once, the sorted columns and the flags written once —
    at 2^19 rows 18 MiB + 18 MiB + 0.5 MiB, about 11.4 µs at
    3.35 TB/s."""
    n = cols.shape[1]
    if n < 8 or n & (n - 1):
        raise ValueError(f"K7 wants a power of two >= 8 rows, got {n}")
    _check("cols", cols, (NUM_COLS, n))
    if _device_kind(cols) == "cpu":
        return sort_dedup_plain(cols)
    out = torch.empty_like(cols)
    same = torch.empty(n, dtype=torch.bool, device=cols.device)
    work = torch.empty(n * NUM_COLS, dtype=torch.int32, device=cols.device)
    with torch.cuda.device(cols.device):
        rc = _cuda.lib().dbeel_bitonic_sort_dedup_cols(
            cols.data_ptr(), n, work.data_ptr(), out.data_ptr(),
            same.data_ptr(), _stream(cols),
        )
    _cuda.check(rc, "sort_dedup_kernel")
    _cuda.count("K7")
    return out, same


def stage_columns(cols: columnar.MergeColumns) -> np.ndarray:
    """The nine u32 operands of ``cols`` as a (9, pow2(n)) array,
    ``U32_MAX``-padded (dbeel_tpu/ops/merge.py:78-91)."""
    n = len(cols)
    p = _pad_to_pow2(n)
    out = np.full((NUM_COLS, p), _U32_MAX, dtype=np.uint32)
    kw = cols.key_words
    ts_inv = ~cols.timestamp
    out[0:4, :n] = kw[:, :4].T
    out[4, :n] = cols.key_size
    out[5, :n] = (ts_inv >> np.uint64(32)).astype(np.uint32)
    out[6, :n] = (ts_inv & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out[7, :n] = ~cols.src
    out[8, :n] = np.arange(n, dtype=np.uint32)  # carried payload
    return out


def device_sort_dedup(
    cols: columnar.MergeColumns, device=None
) -> Tuple[np.ndarray, np.ndarray]:
    """Run K7 over staged merge columns on ``device`` (``cuda`` unless
    the caller names ``cpu``, which runs the plain version).

    Returns (perm, same) as numpy arrays: ``perm`` is the merged order
    (indices into ``cols``), ``same[i]`` flags a duplicate of the key at
    ``perm[i-1]`` (provisional for keys longer than the 16-byte prefix —
    the caller resolves those on the host)."""
    dev = _cuda.resolve_device(device)
    n = len(cols)
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, bool)
    out, same = sort_dedup_kernel(to_tensor(stage_columns(cols), dev))
    # The padding sorts strictly last (key_len is U32_MAX there, real
    # keys never reach it), so rows [:n] are exactly the real ones.
    perm = out[8, :n].cpu().numpy().view(np.uint32).astype(np.int64)
    return perm, same[:n].cpu().numpy()
