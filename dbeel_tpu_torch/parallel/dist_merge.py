"""Distributed compaction merge over a partition mesh (sample sort).

The counterpart of ``dbeel_tpu/parallel/dist_merge.py``.  Entries are
split over the mesh's partitions and a classic distributed sample sort
runs on each (``_per_device``, in order):

  1. local sort of the partition's slice (K5, ``ops/bitonic.py``)
  2. samples: the sorted first key word at ``arange(32) * m // 32``,
     gathered from every partition (all_gather)
  3. splitters chosen from the gathered samples, identical on every
     partition, then bucket + count + overflow + layout of the
     fixed-capacity, sentinel-padded send rows — one launch (K9b) —
     then the all_to_all exchange
  4. final local sort of the received key range (K5) + duplicate flags

Partitioning is by the first 4 key bytes (word k0); entries with equal
full keys share k0, so duplicates always land on one partition and
dedup needs no cross-partition pass.  Heavy first-word skew only costs
balance, never correctness: a partition whose bucket outgrows the
exchange capacity reports overflow, and the merge then runs the
single-card path (``_single_device_fallback``, K4) — the reference's
own algorithm, counted in ``dist_stats``.

One process drives every partition, as ``shard_map`` does in
``dbeel_tpu`` (single controller: one program, every device of the
mesh).  The two collectives are therefore not ``torch.distributed``
calls — that is one process per rank, and NCCL refuses two ranks on
one card, which a repeated-device mesh needs — but device copies
between the partitions' tensors: ``Tensor.copy_`` when both lie on one
card (one stream, so in order), and a peer copy when they lie on two,
which first waits on an event recorded on the source card's stream.
K9b is a CUDA kernel in ``csrc/dist.cu`` whose blocks pick the
splitters from the samples themselves (K9a, the pick, has no launch of
its own); the pick and the scatter each have a plain PyTorch version
here (the JAX body's own formulation: sort and slice; bucket by
comparison, counts, cumsum, scatter), used for CPU tensors.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..ops import _cuda, bitonic
from ..ops.bitonic import (
    NUM_COLS,
    _check,
    _device_kind,
    _from_u64,
    _pow2,
    _stream,
    _u64,
)
from ..storage import columnar
from ..storage.compaction import ColumnarMergeStrategy
from .mesh import Mesh

_SENTINEL = 0xFFFFFFFF
_NUM_SAMPLES = 32  # per-partition splitter samples

# Process-wide accounting: merges the mesh produced (``runs``), merges
# that took the single-card path (``fallbacks``: one partition, no
# rows, overflow, or the defensive size check) and the valid rows the
# exchange could not hold (``overflow_rows``).
dist_stats = {"runs": 0, "fallbacks": 0, "overflow_rows": 0}


# ----------------------------------------------------------------------
# The splitter pick and K9b: plain versions and the kernel wrapper
# ----------------------------------------------------------------------


def splitters_plain(samples: torch.Tensor, n_dev: int) -> torch.Tensor:
    """The splitter pick's plain version (K9a): the samples sorted as
    unsigned words, every 32nd kept (dist_merge.py:84-86)."""
    ordered = torch.sort(_u64(samples)).values
    step = ordered.shape[0] // n_dev
    return _from_u64(ordered[step - 1 :: step][: n_dev - 1])


def bucket_scatter_plain(
    local: torch.Tensor, splitters: torch.Tensor, capacity: int, n_dev: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9b's plain version, the JAX body's formulation (:88-102):
    bucket by unsigned comparison with the splitters, counts over the
    valid rows, exclusive cumsum, ``col = i - starts[bucket]``, and the
    rows scattered into a sentinel-filled (n_dev, capacity, 9) buffer,
    dropping ``col >= capacity``."""
    m = local.shape[0]
    dev = local.device
    k0 = _u64(local[:, 0])
    bucket = (k0[:, None] > _u64(splitters)[None, :]).sum(dim=1)
    valid = local[:, 4] != -1  # key_len is not the sentinel
    counts = (
        (bucket[:, None] == torch.arange(n_dev, device=dev)[None, :])
        & valid[:, None]
    ).sum(dim=0)
    starts = torch.cat(
        [torch.zeros(1, dtype=counts.dtype, device=dev),
         torch.cumsum(counts, 0)[:-1]]
    )
    col = torch.arange(m, device=dev) - starts[bucket]
    overflow = ((col >= capacity) & valid).sum().to(torch.int32).reshape(1)
    send = torch.full((n_dev, capacity, NUM_COLS), -1, dtype=torch.int32,
                      device=dev)
    keep = (col >= 0) & (col < capacity)
    rows = torch.where(valid[:, None], local, torch.full_like(local, -1))
    send[bucket[keep], col[keep]] = rows[keep]
    return send, overflow


def pick_scatter_plain(
    local: torch.Tensor, samples: torch.Tensor, capacity: int, n_dev: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K9b's plain version from the samples: the plain pick, then the
    plain scatter — (send, overflow, splitters)."""
    spl = splitters_plain(samples, n_dev)
    return (*bucket_scatter_plain(local, spl, capacity, n_dev), spl)


def bucket_scatter_kernel(
    local: torch.Tensor,  # (m, 9) u32 bits, sorted rows
    samples: torch.Tensor,  # (n_dev * 32,) the gathered samples
    capacity: int,
    n_dev: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K9b — replaces the splitter and bucket/scatter steps of
    dbeel_tpu/parallel/dist_merge.py:_per_device (:76-102): the
    splitters picked from the gathered samples, the sorted local rows
    laid out as the (n_dev, capacity, 9) send buffer, and the overflow
    count (1,).  Returns (send, overflow, splitters (n_dev - 1,)).  On
    the card one launch: every block orders the samples (in a warp's
    registers up to 256 of them, in shared memory above) and takes the
    splitters it needs (the pick, K9a, has no launch of its own), finds
    its bucket's run of rows by a warp-wide
    search and copies it as one word range in 16-byte stores, then the
    sentinel; block (0, 0) writes the overflow and the splitters
    (csrc/dist.cu).  Bound (bytes): the local rows read once, the send
    buffer written once — at m = 131072, capacity = 65568, n_dev = 4,
    4.7 MB + 9.4 MB, about 4.2 µs at 3.35 TB/s."""
    m = local.shape[0]
    s = samples.shape[0]
    if not 2 <= n_dev <= 192 or capacity < 1:
        raise ValueError(f"K9b: n_dev {n_dev}, capacity {capacity}")
    if s != n_dev * _NUM_SAMPLES:
        raise ValueError(f"K9b wants n_dev * 32 samples, got {s} for "
                         f"n_dev {n_dev}")
    if max(m, capacity) * NUM_COLS >= 1 << 32:
        raise ValueError(f"K9b: {m} rows or capacity {capacity} past "
                         "32-bit word offsets")
    _check("local", local, (m, NUM_COLS))
    _check("samples", samples, (s,))
    if _device_kind(local, samples) == "cpu":
        return pick_scatter_plain(local, samples, capacity, n_dev)
    send = torch.empty((n_dev, capacity, NUM_COLS), dtype=torch.int32,
                       device=local.device)
    overflow = torch.empty(1, dtype=torch.int32, device=local.device)
    spl = torch.empty(n_dev - 1, dtype=torch.int32, device=local.device)
    with torch.cuda.device(local.device):
        rc = _cuda.dist_lib().dbeel_dist_bucket_scatter(
            local.data_ptr(), m, samples.data_ptr(), n_dev, capacity,
            send.data_ptr(), overflow.data_ptr(), spl.data_ptr(),
            _stream(local),
        )
    _cuda.check(rc, "bucket_scatter_kernel")
    _cuda.count("K9b")
    return send, overflow, spl


# ----------------------------------------------------------------------
# The per-partition program and its collectives
# ----------------------------------------------------------------------


def _copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    """One piece of a collective.  On one device: ``copy_`` on its
    stream.  Across cards: the destination's stream waits on an event
    recorded on the source's stream, then the peer copy (PyTorch runs
    it on the source's stream and makes the destination's stream wait
    for its end)."""
    if dst.device != src.device and src.device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(src.device))
        torch.cuda.current_stream(dst.device).wait_event(ready)
        dst.copy_(src, non_blocking=True)
    else:
        dst.copy_(src)


def _all_gather(parts: List[torch.Tensor], device) -> torch.Tensor:
    """``lax.all_gather(tiled=True)`` for one receiver: the partitions'
    pieces concatenated in partition order on ``device``."""
    size = parts[0].shape[0]
    out = torch.empty((size * len(parts),) + tuple(parts[0].shape[1:]),
                      dtype=parts[0].dtype, device=device)
    for e, part in enumerate(parts):
        _copy(out[e * size : (e + 1) * size], part)
    return out


def _all_to_all(sends: List[torch.Tensor], d: int, device) -> torch.Tensor:
    """``lax.all_to_all(split_axis=0, concat_axis=0, tiled=True)`` for
    receiver ``d``: slot ``d`` of every partition's send buffer,
    concatenated in partition order → (n_dev * capacity, 9)."""
    n_dev, capacity = sends[0].shape[:2]
    out = torch.empty((n_dev * capacity, NUM_COLS), dtype=torch.int32,
                      device=device)
    for e, send in enumerate(sends):
        _copy(out[e * capacity : (e + 1) * capacity], send[d])
    return out


def _local_sort(stack: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort rows of an (M, 9) stack by the first 8 columns (K5).  Pads
    to a power of two with sentinel rows that sort last, then slices
    back.  Returns (sorted, same-key flags)."""
    m = stack.shape[0]
    p = _pow2(m)
    if p != m:
        pad = torch.full((p - m, NUM_COLS), -1, dtype=torch.int32,
                         device=stack.device)
        stack = torch.cat([stack, pad])
    out, same = bitonic.sort_stack_kernel(stack)
    return out[:m], same[:m]


def _per_device(blocks: List[torch.Tensor], mesh: Mesh, capacity: int,
                n_dev: int):
    """The shard_map body (dist_merge.py:67), run for every partition
    at each step: ``blocks[d]`` is partition d's (M, 9) slice on
    ``mesh.devices[d]``.  Returns per-partition lists (out, same,
    overflow)."""
    devs = mesh.devices
    m = blocks[0].shape[0]
    locals_, samples = [], []
    for block in blocks:
        local, _ = _local_sort(block)
        pos = torch.arange(_NUM_SAMPLES, device=block.device) * m // _NUM_SAMPLES
        locals_.append(local)
        samples.append(local[pos, 0])
    sends, overflows = [], []
    for local, dev in zip(locals_, devs):
        send, over, _ = bucket_scatter_kernel(
            local, _all_gather(samples, dev), capacity, n_dev
        )
        sends.append(send)
        overflows.append(over)
    outs, sames = [], []
    for d, dev in enumerate(devs):
        out, same = _local_sort(_all_to_all(sends, d, dev))
        outs.append(out)
        sames.append(same)
    return outs, sames, overflows


def _dist_kernel(stack: np.ndarray, mesh: Mesh, capacity: int, n_dev: int):
    """The sharded program (dist_merge.py:117): partition d's block of
    the (n_dev * M, 9) stack goes to ``mesh.devices[d]`` and
    ``_per_device`` runs.  Returns per-partition lists: out
    (n_dev * capacity, 9), same (n_dev * capacity,), overflow (1,)."""
    if mesh.size != n_dev:
        raise ValueError(f"mesh of {mesh.size} partitions, n_dev {n_dev}")
    m = stack.shape[0] // n_dev
    blocks = [
        bitonic.to_tensor(stack[d * m : (d + 1) * m], dev)
        for d, dev in enumerate(mesh.devices)
    ]
    return _per_device(blocks, mesh, capacity, n_dev)


def build_stack(cols: columnar.MergeColumns, n_dev: int) -> np.ndarray:
    """(N_padded, 9) uint32 operand stack, padded so the leading dim
    divides the mesh.

    Rows are INTERLEAVED across partition blocks (block d gets original
    rows d::n_dev): inputs are concatenated sorted runs, so a
    contiguous block layout would give each partition a narrow slice of
    the keyspace and funnel it into a handful of all_to_all buckets,
    overflowing the fixed exchange capacity even with zero skew.
    Interleaving makes every local slice a stride-sample of the global
    key distribution.  The idx column carries original row identity, so
    downstream consumers never see the permutation."""
    n = len(cols)
    m = -(-n // n_dev)  # ceil
    m = max(m, _NUM_SAMPLES)
    p = m * n_dev
    stack = np.full((p, NUM_COLS), _SENTINEL, dtype=np.uint32)
    kw = cols.key_words
    ts_inv = ~cols.timestamp
    stack[:n, 0:4] = kw[:, :4]
    stack[:n, 4] = cols.key_size
    stack[:n, 5] = (ts_inv >> np.uint64(32)).astype(np.uint32)
    stack[:n, 6] = (ts_inv & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    stack[:n, 7] = ~cols.src
    stack[:n, 8] = np.arange(n, dtype=np.uint32)
    # Interleave: block d = rows d::n_dev of the run-concatenated order
    # (the sentinel padding disperses too; it sorts last everywhere and
    # is masked out of the bucket counts).
    return np.ascontiguousarray(
        stack.reshape(m, n_dev, NUM_COLS)
        .transpose(1, 0, 2)
        .reshape(p, NUM_COLS)
    )


def distributed_sort_dedup(
    cols: columnar.MergeColumns,
    mesh: Mesh,
    capacity_factor: float = 2.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Multi-partition merge: returns (perm, same) like
    ``ops.merge.device_sort_dedup``.  Takes the single-card path when
    the mesh has one partition, there are no rows, or bucket skew
    overflows the exchange capacity."""
    n = len(cols)
    n_dev = mesh.size
    if n == 0 or n_dev == 1:
        return _single_device_fallback(cols, mesh.devices[0])
    stack = build_stack(cols, n_dev)
    m = stack.shape[0] // n_dev
    capacity = int(m * capacity_factor / n_dev) + _NUM_SAMPLES
    outs, sames, overflows = _dist_kernel(stack, mesh, capacity, n_dev)
    overflow = sum(int(o.item()) & _SENTINEL for o in overflows)
    if overflow > 0:
        dist_stats["overflow_rows"] += overflow
        return _single_device_fallback(cols, mesh.devices[0])
    # Per-partition blocks are disjoint ascending key ranges:
    # concatenate the valid rows in partition order.
    perms, same_l = [], []
    for out, same in zip(outs, sames):
        idx = out[:, 8].cpu().numpy().view(np.uint32)
        is_real = idx != _SENTINEL
        perms.append(idx[is_real].astype(np.int64))
        same_l.append(same.cpu().numpy()[is_real])
    perm = np.concatenate(perms)
    same_np = np.concatenate(same_l)
    if perm.size != n:
        # Defensive: anything unexpected (shouldn't happen) → fallback.
        return _single_device_fallback(cols, mesh.devices[0])
    dist_stats["runs"] += 1
    return perm, same_np


def _single_device_fallback(cols: columnar.MergeColumns, device):
    """cols always stage sorted sstable runs, so the bitonic merge
    network (K4) serves as the single-card path, on ``device`` (the
    mesh's first partition)."""
    dist_stats["fallbacks"] += 1
    run_counts = np.bincount(cols.src).tolist() if len(cols) else []
    return bitonic.device_merge_sorted_runs(cols, run_counts, device)


class DistributedMergeStrategy(ColumnarMergeStrategy):
    """CompactionStrategy running the sort across the whole mesh."""

    name = "distributed"

    # Mirrors DeviceMergeStrategy.PIPELINE_MIN_BYTES: big merges take
    # the partitioned native pipeline with the launch batch spread over
    # the mesh (each partition's slots on its own device), not the
    # load-everything sample sort.
    PIPELINE_MIN_BYTES = 64 << 20

    def __init__(self, mesh: Mesh) -> None:
        self.mesh = mesh
        self.device = mesh.devices[0]

    def merge(
        self,
        sources,
        dir_path,
        output_index,
        cache,
        keep_tombstones,
        bloom_min_size,
    ):
        total = sum(getattr(s, "data_size", 0) for s in sources)
        if total >= self.PIPELINE_MIN_BYTES:
            from ..ops.pipeline import pipeline_merge

            result = pipeline_merge(
                sources,
                dir_path,
                output_index,
                keep_tombstones,
                bloom_min_size,
                device=self.device,
                throttle=self.throttle,
                tombstone_drop_before=self.tombstone_drop_before,
                mesh=self.mesh,
            )
            if result is not None:
                return result
        return super().merge(
            sources,
            dir_path,
            output_index,
            cache,
            keep_tombstones,
            bloom_min_size,
        )

    def sort_and_dedup(self, cols):
        perm, same = distributed_sort_dedup(cols, self.mesh)
        # Long keys: the host fixes order + dedup (see
        # DeviceFullMergeStrategy).
        if (cols.key_size > columnar.KEY_PREFIX_BYTES).any():
            perm = columnar.fixup_long_key_ties(cols, perm)
            return perm, columnar.dedup_mask(cols, perm)
        return perm, ~same
