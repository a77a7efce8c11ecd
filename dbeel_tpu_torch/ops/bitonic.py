"""Bitonic merge network — the compaction merge kernels on the card.

Compaction's inputs are K *already-sorted* runs (SSTables are sorted by
construction), so the merge is a bitonic merge network: log2(K) levels,
each pairing neighbouring runs (the odd one reversed, so the pair is a
bitonic sequence) and sorting the pair with half-cleaner stages of
strides P_l, P_l/2, ..., 1.  ``dbeel_tpu/ops/bitonic.py`` runs it as
jax.jit programs on a TPU; here the six networks on the storage path
are CUDA kernels written for Hopper — K4 and K5 the network stage for
stage (``csrc/bitonic.cu``, with the stages grouped into two passes a
level), K1-K3 and K6 a merge-path merge (``csrc/merge_path.cu``), which
may compare rows in another order because every word of their rows is
compared (the source's note):

  K1 merge_runs_prefix32_packed_batch_kernel — pipeline, 1-word operand
  K2 merge_runs_prefix64_packed_batch_kernel — pipeline, exact 2 words
  K3 merge_runs_prefix_kernel — single-shot merges (8-byte prefixes)
  K4 merge_runs_perm_kernel — the full 9-column stack (tie fallback,
     device_full)
  K5 merge_runs_kernel / sort_stack_kernel — the whole sorted stack
     (the hash memtable's flush sort, ops/sort.py)
  K6 merge_runs_prefix_batch_kernel — K3 over J independent jobs (the
     compaction coalescer, server/coalescer.py)

Each wrapper takes int32 tensors that carry uint32 bits (PyTorch has no
arithmetic on ``torch.uint32``), launches the kernel for a CUDA tensor
(or raises) and runs the network's plain PyTorch version — the same
stages in int64 — for a CPU tensor.  ``launches`` counts kernel
launches per wrapper (one registry for every kernel module, taken
under a lock: wrappers launch from several threads).

Row format of the 9-column stack (K4):
  cols 0-3 k0..k3 (16B big-endian key prefix), 4 key_len,
  5-6 ~ts hi/lo, 7 ~src, 8 carried entry index.
Lexicographic comparator over cols 0-7; sentinel rows (all 0xFFFFFFFF)
sort last.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..storage import columnar
from . import _cuda

NUM_COLS = 9
NUM_KEY_COLS = 8
NUM_EQ_COLS = 5  # key identity = prefix words + key_len
SENTINEL = np.uint32(0xFFFFFFFF)
_U32 = 0xFFFFFFFF

# The launch counters are shared by every kernel module (ops/_cuda.py).
launches = _cuda.launches
reset_launches = _cuda.reset_launches


# ----------------------------------------------------------------------
# uint32 <-> tensor boundary
# ----------------------------------------------------------------------


def to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """numpy uint32 → int32 tensor of the same bits on ``device``."""
    t = torch.from_numpy(
        np.ascontiguousarray(arr, dtype=np.uint32).view(np.int32)
    )
    return t.to(device) if torch.device(device).type != "cpu" else t


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor → numpy uint32 of the same bits (host copy)."""
    return t.cpu().numpy().view(np.uint32)


def _from_u64(x: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 values → int32 holding the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _u64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & _U32


def _check(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous int32 tensor")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")


def _check_runs(k: int, p: int) -> None:
    if k & (k - 1) or p & (p - 1) or k < 1 or p < 1:
        raise ValueError(f"runs must be powers of two, got K={k} P={p}")
    if k * p >= 1 << 32:
        raise ValueError("K*P must stay below 2^32 (packed index)")


def _device_kind(*ts: torch.Tensor) -> str:
    kinds = {t.device.type for t in ts}
    if len(kinds) != 1 or len({t.device for t in ts}) != 1:
        raise ValueError("all operands must lie on one device")
    kind = kinds.pop()
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {kind}")
    return kind


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ----------------------------------------------------------------------
# Plain PyTorch versions: the JAX network stage for stage, in int64.
# ----------------------------------------------------------------------


def _lex_gt(a: torch.Tensor, b: torch.Tensor, ncmp: int) -> torch.Tensor:
    gt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    for c in range(ncmp):
        ac, bc = a[..., c], b[..., c]
        gt = gt | (eq & (ac > bc))
        eq = eq & (ac == bc)
    return gt


def _bitonic_to_sorted(x: torch.Tensor, ncmp: int) -> torch.Tensor:
    """(B, L, C) rows bitonic along axis 1 → ascending rows: stages
    with strides L/2, ..., 1, swap iff lo > hi strictly."""
    b, l, c = x.shape
    s = l // 2
    while s >= 1:
        y = x.reshape(b, l // (2 * s), 2, s, c)
        lo, hi = y[:, :, 0], y[:, :, 1]
        swap = _lex_gt(lo, hi, ncmp)[..., None]
        x = torch.stack(
            [torch.where(swap, hi, lo), torch.where(swap, lo, hi)], dim=2
        ).reshape(b, l, c)
        s //= 2
    return x


def _merge_plain(x: torch.Tensor, ncmp: int) -> torch.Tensor:
    """(J, K, P, C) sorted runs → (J, K*P, C): per level, each even
    run concatenated with its odd neighbour reversed, then sorted."""
    while x.shape[1] > 1:
        y = torch.cat([x[:, 0::2], x[:, 1::2].flip(2)], dim=2)
        j, k, l, c = y.shape
        x = _bitonic_to_sorted(y.reshape(j * k, l, c), ncmp).reshape(
            j, k, l, c
        )
    return x[:, 0]


def _index_column(counts: torch.Tensor, k: int, p: int) -> torch.Tensor:
    """(J, K) counts → (J, K, P) iota k*P+p, SENTINEL past the count."""
    dev = counts.device
    pos = torch.arange(p, dtype=torch.int64, device=dev)
    iota = torch.arange(k, dtype=torch.int64, device=dev)[:, None] * p + pos
    valid = pos[None, None, :] < _u64(counts)[:, :, None]
    return torch.where(
        valid, iota[None], torch.full_like(iota[None], _U32)
    )


def _pack_rids_plain(
    idx: torch.Tensor, logp: int, pack_bits: int
) -> torch.Tensor:
    """(J, N) sorted indices → (J, ceil(N/per)) bit-packed run ids."""
    per = 32 // pack_bits
    j, n = idx.shape
    pad = (-n) % per
    if pad:
        idx = torch.cat(
            [idx, torch.full((j, pad), _U32, dtype=idx.dtype,
                             device=idx.device)],
            dim=1,
        )
    rid = (idx >> logp) & ((1 << pack_bits) - 1)
    shifts = torch.arange(per, dtype=torch.int64, device=idx.device)
    return (rid.reshape(j, -1, per) << (shifts * pack_bits)).sum(-1)


def prefix32_packed_plain(vals, counts, pack_bits: int) -> torch.Tensor:
    j, k, p = vals.shape
    x = torch.stack([_u64(vals), _index_column(counts, k, p)], dim=3)
    out = _merge_plain(x, 2)
    return _from_u64(
        _pack_rids_plain(out[..., 1], p.bit_length() - 1, pack_bits)
    )


def prefix64_packed_plain(prefixes, counts, pack_bits: int) -> torch.Tensor:
    j, k, p, _ = prefixes.shape
    x = torch.cat(
        [_u64(prefixes), _index_column(counts, k, p)[..., None]], dim=3
    )
    out = _merge_plain(x, 3)
    return _from_u64(
        _pack_rids_plain(out[..., 2], p.bit_length() - 1, pack_bits)
    )


def prefix_top_batch_plain(prefixes, counts, out_rows: int) -> torch.Tensor:
    j, k, p, _ = prefixes.shape
    x = torch.cat(
        [_u64(prefixes), _index_column(counts, k, p)[..., None]], dim=3
    )
    out = _merge_plain(x, 3)
    return _from_u64(out[:, :out_rows, 2])


def prefix_top_plain(prefixes, counts, out_rows: int) -> torch.Tensor:
    return prefix_top_batch_plain(prefixes[None], counts[None], out_rows)[0]


def _merged_with_same_plain(stacks) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, P, 9) → the sorted (K*P, 9) stack in int64 + same-key flags
    over cols 0-4, never on a sentinel row (_merged_with_same)."""
    out = _merge_plain(_u64(stacks)[None], NUM_KEY_COLS)[0]
    eq = torch.ones(out.shape[0] - 1, dtype=torch.bool, device=out.device)
    for c in range(NUM_EQ_COLS):
        eq = eq & (out[1:, c] == out[:-1, c])
    eq = eq & (out[1:, 4] != _U32)
    same = torch.cat(
        [torch.zeros(1, dtype=torch.bool, device=out.device), eq]
    )
    return out, same


def perm_plain(stacks) -> Tuple[torch.Tensor, torch.Tensor]:
    out, same = _merged_with_same_plain(stacks)
    return _from_u64(out[:, 8]), same


def merge_rows_plain(stacks) -> Tuple[torch.Tensor, torch.Tensor]:
    out, same = _merged_with_same_plain(stacks)
    return _from_u64(out), same


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------


def packed_words(k: int, p: int, pack_bits: int) -> int:
    per = 32 // pack_bits
    return (k * p + per - 1) // per


def merge_runs_prefix32_packed_batch_kernel(
    vals: torch.Tensor,  # (J, K, P) u32 bits — J partitions per launch
    counts: torch.Tensor,  # (J, K) u32 bits
    pack_bits: int,
) -> torch.Tensor:
    """K1 — replaces dbeel_tpu/ops/bitonic.py:235
    merge_runs_prefix32_packed_batch_kernel.  J keyspace partitions
    merged in one launch on (u32 value, device-built index); returns
    the bit-packed run-id sequence (J, ceil(K*P*pack_bits/32)).
    Each run must be sorted, with rows past its count SENTINEL: then the
    merge path (csrc/merge_path.cu, log2(K) launches) gives the
    network's bits.  Bound (bytes): the operand read once plus the
    packed output written once — at the 10M-key shape (4, 8, 131072)
    16 MiB + 2 MiB, about 5.6 µs at 3.35 TB/s."""
    j, k, p = vals.shape
    _check_runs(k, p)
    _check("vals", vals, (j, k, p))
    _check("counts", counts, (j, k))
    _check_pack_bits(pack_bits)
    if _device_kind(vals, counts) == "cpu":
        return prefix32_packed_plain(vals, counts, pack_bits)
    out = torch.empty(
        (j, packed_words(k, p, pack_bits)), dtype=torch.int32,
        device=vals.device,
    )
    work = _merge_path_work(j, k, p, vals.device)
    with torch.cuda.device(vals.device):
        rc = _cuda.merge_path_lib().dbeel_merge_path_prefix32_packed(
            vals.data_ptr(), counts.data_ptr(), j, k, p, pack_bits,
            _ptr(work), out.data_ptr(), _stream(vals),
        )
    _cuda.check(rc, "merge_runs_prefix32_packed_batch_kernel")
    _cuda.count("K1")
    return out


def _merge_path_work(j: int, k: int, p: int, device):
    """Work halves of the merge-path kernels (csrc/merge_path.cu): one
    per intermediate level, at most two (they ping-pong), of one idx
    word a row; None for K <= 2, which has no intermediate level."""
    halves = min(2, max(0, k.bit_length() - 2))
    if not halves:
        return None
    return torch.empty(halves * j * k * p, dtype=torch.int32, device=device)


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _check_pack_bits(pack_bits: int) -> None:
    if pack_bits not in (1, 2, 4, 8, 16):
        raise ValueError(f"pack_bits {pack_bits} not in 1, 2, 4, 8, 16")


def _check_rows8(name: str, t: torch.Tensor) -> None:
    """The merge-path kernels read a row's two words as one 8-byte
    load."""
    if t.data_ptr() % 8:
        raise ValueError(f"{name}: want an 8-byte-aligned tensor")


def merge_runs_prefix64_packed_batch_kernel(
    prefixes: torch.Tensor,  # (J, K, P, 2) u32 bits
    counts: torch.Tensor,  # (J, K)
    pack_bits: int,
) -> torch.Tensor:
    """K2 — replaces dbeel_tpu/ops/bitonic.py:251
    merge_runs_prefix64_packed_batch_kernel: K1's merge on the exact
    2-word 8-byte prefixes (partitions whose shifted 1-word operand
    would collapse dense clusters).  Each run must be sorted on its two
    words, with rows past its count SENTINEL in both: then the merge
    path (csrc/merge_path.cu, log2(K) launches) gives the network's
    bits.  Bound (bytes): operand read once plus packed output written
    once — 32 MiB + 2 MiB at (4, 8, 131072), about 10.6 µs at
    3.35 TB/s."""
    j, k, p, _ = prefixes.shape
    _check_runs(k, p)
    _check("prefixes", prefixes, (j, k, p, 2))
    _check("counts", counts, (j, k))
    _check_pack_bits(pack_bits)
    if _device_kind(prefixes, counts) == "cpu":
        return prefix64_packed_plain(prefixes, counts, pack_bits)
    _check_rows8("prefixes", prefixes)
    out = torch.empty(
        (j, packed_words(k, p, pack_bits)), dtype=torch.int32,
        device=prefixes.device,
    )
    work = _merge_path_work(j, k, p, prefixes.device)
    with torch.cuda.device(prefixes.device):
        rc = _cuda.merge_path_lib().dbeel_merge_path_prefix64_packed(
            prefixes.data_ptr(), counts.data_ptr(), j, k, p, pack_bits,
            _ptr(work), out.data_ptr(), _stream(prefixes),
        )
    _cuda.check(rc, "merge_runs_prefix64_packed_batch_kernel")
    _cuda.count("K2")
    return out


def merge_runs_prefix_kernel(
    prefixes: torch.Tensor,  # (K, P, 2) u32 bits
    counts: torch.Tensor,  # (K,) valid rows per run
    out_rows: int,
) -> torch.Tensor:
    """K3 — replaces dbeel_tpu/ops/bitonic.py:153
    merge_runs_prefix_kernel and its pipelined twin
    _prefix_kernel_from_runs (:379): K runs merged on (k0, k1, iota),
    the top ``out_rows`` packed ``(run << logP) | pos`` indices out.
    Each run must be sorted on its two words, with rows past its count
    SENTINEL in both: then the merge path (csrc/merge_path.cu, log2(K)
    launches, none past ``out_rows``) gives the network's bits.  Bound
    (bytes): operand read once plus ``out_rows`` words written —
    16 MiB + 8 MiB at (8, 2^18, 2) with 2M rows out, about 7.5 µs at
    3.35 TB/s."""
    k, p, _ = prefixes.shape
    _check_runs(k, p)
    _check("prefixes", prefixes, (k, p, 2))
    _check("counts", counts, (k,))
    if not 0 <= out_rows <= k * p:
        raise ValueError(f"out_rows {out_rows} outside [0, {k * p}]")
    if _device_kind(prefixes, counts) == "cpu":
        return prefix_top_plain(prefixes, counts, out_rows)
    return _prefix_top_launch(
        prefixes[None], counts[None], out_rows,
        "merge_runs_prefix_kernel", "K3",
    )[0]


def _prefix_top_launch(
    prefixes: torch.Tensor,  # (J, K, P, 2) u32 bits on the card
    counts: torch.Tensor,  # (J, K)
    out_rows: int,
    name: str,
    counter: str,
) -> torch.Tensor:
    """K3's and K6's launch: dbeel_merge_path_prefix_top over J jobs →
    (J, out_rows); counts one launch under ``counter``."""
    j, k, p, _ = prefixes.shape
    _check_rows8("prefixes", prefixes)
    out = torch.empty(
        (j, out_rows), dtype=torch.int32, device=prefixes.device
    )
    work = _merge_path_work(j, k, p, prefixes.device)
    with torch.cuda.device(prefixes.device):
        rc = _cuda.merge_path_lib().dbeel_merge_path_prefix_top(
            prefixes.data_ptr(), counts.data_ptr(), j, k, p, out_rows,
            _ptr(work), out.data_ptr(), _stream(prefixes),
        )
    _cuda.check(rc, name)
    _cuda.count(counter)
    return out


def merge_runs_perm_kernel(
    stacks: torch.Tensor,  # (K, P, 9) u32 bits
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 — replaces dbeel_tpu/ops/bitonic.py:104 merge_runs_perm_kernel
    (network :81 _merged_with_same): lexicographic merge on cols 0-7 of
    the 9-column stack → (sorted entry indices (K*P,), same-key flags
    (K*P,) bool).  On the card K5's schedule (csrc/bitonic.cu, "K4 and
    K5: the same network in fewer passes") with an epilogue that writes
    word 8 alone: 1 + 2 log2(K) launches for runs of 1024 rows or more
    (7 at K = 8).  Bound (bytes): the stack read once plus index and
    flags written once — 9 MiB + 1.25 MiB at (8, 2^15, 9), about
    3.2 µs at 3.35 TB/s."""
    k, p, _ = stacks.shape
    _check_runs(k, p)
    _check("stacks", stacks, (k, p, NUM_COLS))
    if _device_kind(stacks) == "cpu":
        return perm_plain(stacks)
    idx = torch.empty(k * p, dtype=torch.int32, device=stacks.device)
    same = torch.empty(k * p, dtype=torch.bool, device=stacks.device)
    work = torch.empty(
        k * p * NUM_COLS, dtype=torch.int32, device=stacks.device
    )
    with torch.cuda.device(stacks.device):
        rc = _cuda.lib().dbeel_bitonic_perm(
            stacks.data_ptr(), k, p, work.data_ptr(), idx.data_ptr(),
            same.data_ptr(), _stream(stacks),
        )
    _cuda.check(rc, "merge_runs_perm_kernel")
    _cuda.count("K4")
    return idx, same


def merge_runs_kernel(
    stacks: torch.Tensor,  # (K, P, 9) u32 bits
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 — replaces dbeel_tpu/ops/bitonic.py:95 merge_runs_kernel:
    K4's network on the 9-column stack, returning the whole sorted
    stack (K*P, 9) and the same-key flags (K*P,) bool.  On the card the
    same stages run in fewer passes (csrc/bitonic.cu, "K5: the same
    network in fewer passes"): with tiles of 1024 rows in shared memory,
    1 + 2 log2(K*P / 1024) launches.  Bound (bytes): the stack
    read once, the sorted stack and the flags written once — at the
    flush shape (131072, 1, 9) 4.5 MiB + 4.6 MiB, about 2.8 µs at
    3.35 TB/s."""
    k, p, _ = stacks.shape
    _check_runs(k, p)
    _check("stacks", stacks, (k, p, NUM_COLS))
    if _device_kind(stacks) == "cpu":
        return merge_rows_plain(stacks)
    out = torch.empty(
        (k * p, NUM_COLS), dtype=torch.int32, device=stacks.device
    )
    same = torch.empty(k * p, dtype=torch.bool, device=stacks.device)
    work = torch.empty(
        k * p * NUM_COLS, dtype=torch.int32, device=stacks.device
    )
    with torch.cuda.device(stacks.device):
        rc = _cuda.lib().dbeel_bitonic_merge_rows(
            stacks.data_ptr(), k, p, work.data_ptr(), out.data_ptr(),
            same.data_ptr(), _stream(stacks),
        )
    _cuda.check(rc, "merge_runs_kernel")
    _cuda.count("K5")
    return out, same


def sort_stack_kernel(
    stack: torch.Tensor,  # (N, 9) u32 bits, N a power of two
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 as dbeel_tpu/ops/bitonic.py:114 sort_stack_kernel: a full
    sort of an unsorted stack, every row a one-row run (P = 1)."""
    return merge_runs_kernel(stack[:, None, :])


def merge_runs_prefix_batch_kernel(
    prefixes: torch.Tensor,  # (J, K, P, 2) u32 bits — J independent jobs
    counts: torch.Tensor,  # (J, K)
    out_rows: int,
) -> torch.Tensor:
    """K6 — replaces dbeel_tpu/ops/bitonic.py:284
    merge_runs_prefix_batch_kernel: K3's merge over J independent jobs
    (each job's index restarts at 0) in one call → (J, out_rows)
    packed ``(run << logP) | pos``.  Each run must be sorted on its two
    words, with rows past its count SENTINEL in both (the network
    needed only the padding; ``stage_prefixes`` meets both): then the
    merge path (csrc/merge_path.cu, log2(K) launches, none past a job's
    ``out_rows``: 2 at K = 4) gives the network's bits.  Bound (bytes):
    the prefixes read once plus J*out_rows words written, so it
    follows out_rows — at the coalesced shape (8, 4, 131072, 2) with
    327680 rows out a job (chip_smoke.py's ragged counts, rounded up to
    65536 rows), 32 MiB + 10 MiB, about 13.1 µs at 3.35 TB/s."""
    j, k, p, _ = prefixes.shape
    _check_runs(k, p)
    _check("prefixes", prefixes, (j, k, p, 2))
    _check("counts", counts, (j, k))
    if not 0 <= out_rows <= k * p:
        raise ValueError(f"out_rows {out_rows} outside [0, {k * p}]")
    if _device_kind(prefixes, counts) == "cpu":
        return prefix_top_batch_plain(prefixes, counts, out_rows)
    return _prefix_top_launch(
        prefixes, counts, out_rows, "merge_runs_prefix_batch_kernel", "K6"
    )


# ----------------------------------------------------------------------
# Host helpers (staging and decode)
# ----------------------------------------------------------------------


def rid_pack_bits(k2: int) -> int:
    """Smallest packing width in {1,2,4,8,16} holding run-ids < k2."""
    need = max(1, (k2 - 1).bit_length())
    for b in (1, 2, 4, 8, 16):
        if need <= b:
            return b
    raise ValueError(f"too many runs for rid packing: {k2}")


def unpack_rids(
    words: np.ndarray, pack_bits: int, n: int
) -> np.ndarray:
    """Host-side inverse of the run-id packing → (n,) run-ids as uint32."""
    per = 32 // pack_bits
    mask = np.uint32((1 << pack_bits) - 1)
    shifts = (
        np.arange(per, dtype=np.uint32) * np.uint32(pack_bits)
    )
    rids = (words[:, None] >> shifts[None, :]) & mask
    return rids.reshape(-1)[:n]


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def stage_prefixes(
    cols: columnar.MergeColumns,
    run_counts: List[int],
    k: int = 0,
    p: int = 0,
):
    """Host staging for the prefix kernel: sentinel-padded (K, P, 2)
    prefix words, per-run counts, per-run base offsets, and the
    64Ki-bucketed output row count (~n d2h bytes).  ``k``/``p`` may be
    forced larger for batches that need a common shape."""
    n = len(cols)
    k = max(k, _pow2(max(1, len(run_counts))))
    p = max(p, _pow2(max(8, max(run_counts) if run_counts else 8)))
    prefixes = np.full((k, p, 2), SENTINEL, dtype=np.uint32)
    counts = np.zeros(k, dtype=np.uint32)
    bases = np.zeros(k, dtype=np.int64)
    base = 0
    for r, cnt in enumerate(run_counts):
        prefixes[r, :cnt, 0] = cols.key_words[base : base + cnt, 0]
        prefixes[r, :cnt, 1] = cols.key_words[base : base + cnt, 1]
        counts[r] = cnt
        bases[r] = base
        base += cnt
    out_rows = min(k * p, ((n + 65535) >> 16) << 16)
    return prefixes, counts, bases, out_rows


def _decode_packed(packed: np.ndarray, bases: np.ndarray, p: int):
    run = packed >> np.uint32(p.bit_length() - 1)
    pos = packed & np.uint32(p - 1)
    return bases[run.astype(np.int64)] + pos.astype(np.int64)


def device_merge_prefix_order(
    cols: columnar.MergeColumns, run_counts: List[int], device
) -> np.ndarray:
    """Device order of ``cols`` by 8-byte key prefix (ties by staging
    position — resolve with columnar.fixup_and_dedup_prefix
    afterwards).  Returns perm as int64 entry indices."""
    n = len(cols)
    if n == 0:
        return np.zeros(0, np.int64)
    prefixes, counts, bases, out_rows = stage_prefixes(cols, run_counts)
    out = merge_runs_prefix_kernel(
        to_tensor(prefixes, device), to_tensor(counts, device), out_rows
    )
    return _decode_packed(to_numpy(out)[:n], bases, prefixes.shape[1])


def build_run_stacks(
    cols: columnar.MergeColumns, run_counts: List[int]
) -> np.ndarray:
    """Stage merge columns as a (K, P, 9) sentinel-padded uint32 tensor,
    one sorted run per input sstable."""
    k = _pow2(max(1, len(run_counts)))
    p = _pow2(max(8, max(run_counts) if run_counts else 8))
    stacks = np.full((k, p, NUM_COLS), SENTINEL, dtype=np.uint32)
    ts_inv = ~cols.timestamp
    base = 0
    for r, cnt in enumerate(run_counts):
        sl = slice(base, base + cnt)
        stacks[r, :cnt, 0] = cols.key_words[sl, 0]
        stacks[r, :cnt, 1] = cols.key_words[sl, 1]
        stacks[r, :cnt, 2] = cols.key_words[sl, 2]
        stacks[r, :cnt, 3] = cols.key_words[sl, 3]
        stacks[r, :cnt, 4] = cols.key_size[sl]
        stacks[r, :cnt, 5] = (ts_inv[sl] >> np.uint64(32)).astype(np.uint32)
        stacks[r, :cnt, 6] = (
            ts_inv[sl] & np.uint64(0xFFFFFFFF)
        ).astype(np.uint32)
        stacks[r, :cnt, 7] = ~cols.src[sl]
        stacks[r, :cnt, 8] = np.arange(base, base + cnt, dtype=np.uint32)
        base += cnt
    return stacks


def device_merge_prefix_order_pipelined(sources, device):
    """Like device_merge_prefix_order but fed directly from SSTables:
    each run's prefix slice is copied to the device as soon as its file
    is read (a non-blocking copy from pinned memory on a card), so disk
    reads overlap the uploads.  Each file is read exactly once — the
    raw pieces are returned for columnar.assemble_columns.

    Returns (perm int64, pieces) over the sources' concatenated
    entries."""
    device = torch.device(device)
    counts_list = [s.entry_count for s in sources]
    n = sum(counts_list)
    pieces = []
    if n == 0:
        return np.zeros(0, np.int64), pieces
    k = _pow2(max(1, len(sources)))
    p = _pow2(max(8, max(counts_list)))
    on_card = device.type == "cuda"
    if on_card:
        dev = torch.empty((k, p, 2), dtype=torch.int32, device=device)
        if k > len(sources):
            dev[len(sources):].fill_(-1)  # SENTINEL bits
    else:
        host = np.full((k, p, 2), SENTINEL, dtype=np.uint32)
    staged = []  # pinned buffers live until the result is read back
    bases = np.zeros(k, dtype=np.int64)
    base = 0
    for r, src in enumerate(sources):
        cnt = counts_list[r]
        offs, ks, fs = src.read_index_columns()
        raw = src.read_data_bytes()
        pieces.append((raw, offs, ks, fs))
        data = np.frombuffer(raw, dtype=np.uint8)
        words = columnar.prefix_words(data, offs.astype(np.uint64), ks)
        bases[r] = base
        base += cnt
        if on_card:
            pinned = torch.empty((p, 2), dtype=torch.int32, pin_memory=True)
            run = pinned.numpy().view(np.uint32)
            run[cnt:] = SENTINEL
            run[:cnt] = words[:, :2]
            dev[r].copy_(pinned, non_blocking=True)
            staged.append(pinned)
        else:
            host[r, :cnt] = words[:, :2]
    if not on_card:
        dev = to_tensor(host, device)
    counts = np.zeros(k, dtype=np.uint32)
    counts[: len(sources)] = counts_list
    out_rows = min(k * p, ((n + 65535) >> 16) << 16)
    out = merge_runs_prefix_kernel(dev, to_tensor(counts, device), out_rows)
    perm = _decode_packed(to_numpy(out)[:n], bases, p)
    del staged
    return perm, pieces


def device_merge_sorted_runs(
    cols: columnar.MergeColumns, run_counts: List[int], device
) -> Tuple[np.ndarray, np.ndarray]:
    """Host wrapper: (perm, same) over ``cols`` via the 9-column bitonic
    merge (K4)."""
    n = len(cols)
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, bool)
    stacks = build_run_stacks(cols, run_counts)
    idx, same = merge_runs_perm_kernel(to_tensor(stacks, device))
    perm = to_numpy(idx)[:n].astype(np.int64)
    return perm, same[:n].cpu().numpy()
