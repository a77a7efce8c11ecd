"""Compaction coalescer — many shards' merges, one device launch.

A node runs one shard per core, and all of them compact on one card.
Shards submit their staged merge columns here; jobs arriving within a
small window (or up to ``max_batch``) are padded to a common (K, P)
shape and dispatched as ONE batched bitonic-merge launch
(ops/bitonic.py merge_runs_prefix_batch_kernel, K6).  Each shard gets
back its own permutation.

The packing lives in ``pack_jobs``, computed independently of the
device, so the CPU path (``device="cpu"``, K6's plain version) runs the
same batched shape as the card.

One coalescer is shared per device and process (all shards of a node
run on one loop).  A failed launch raises to every job of its batch:
there is no host merge behind it.  The first launch on a card is
recorded in DEVICE_LAST_GOOD.json (``query_kernels._persist_wake``).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops import bitonic, query_kernels
from ..ops._cuda import resolve_device
from ..storage import columnar

log = logging.getLogger(__name__)


class PackedBatch:
    """One coalesced launch: every job's staged prefixes padded to the
    common (jobs, K, P) stack.  ``pad_frac`` measures the padding
    waste — whether the window coalesces similar-shaped jobs."""

    __slots__ = (
        "k", "p", "out_rows", "prefixes", "counts", "bases",
        "real_rows", "pad_frac",
    )

    def __init__(self, k, p, out_rows, prefixes, counts, bases,
                 real_rows, pad_frac) -> None:
        self.k = k
        self.p = p
        self.out_rows = out_rows
        self.prefixes = prefixes
        self.counts = counts
        self.bases = bases
        self.real_rows = real_rows
        self.pad_frac = pad_frac


def pack_jobs(jobs: List[Tuple]) -> PackedBatch:
    """Pack per-shard compaction jobs into ONE batched launch shape:
    K = max run count (next pow2), P = max run length (next pow2),
    every job's 8-byte key prefixes staged into a common (jobs, K, P)
    stack.  Pure host-side packing."""
    k = max(bitonic._pow2(max(1, len(rc))) for _, rc, *_ in jobs)
    p = max(
        bitonic._pow2(max(8, max(rc) if rc else 8))
        for _, rc, *_ in jobs
    )
    out_rows = 0
    staged = []
    real_rows = 0
    for cols, rc, *_ in jobs:
        prefixes, counts, bases, rows = bitonic.stage_prefixes(
            cols, rc, k=k, p=p
        )
        staged.append((prefixes, counts, bases))
        out_rows = max(out_rows, rows)
        # Actual staged rows, NOT stage_prefixes' 64Ki-bucketed
        # out_rows — pad_frac must measure real padding waste.
        real_rows += int(sum(rc))
    batch_prefixes = np.stack([s[0] for s in staged])
    batch_counts = np.stack([s[1] for s in staged])
    bases = [s[2] for s in staged]
    padded = len(jobs) * k * p
    pad_frac = round(1.0 - real_rows / padded, 4) if padded else 0.0
    return PackedBatch(
        int(k), int(p), int(out_rows), batch_prefixes, batch_counts,
        bases, real_rows, pad_frac,
    )


class CompactionCoalescer:
    """``device``: ``cuda`` unless the caller names ``cpu`` (K6's plain
    version); without a card ``cuda`` raises here."""

    def __init__(
        self, window_s: float = 0.01, max_batch: int = 16, device=None
    ) -> None:
        self.device = resolve_device(device)
        self.window_s = window_s
        self.max_batch = max_batch
        self._pending: List[Tuple] = []
        self._flush_task: Optional[asyncio.Task] = None
        self._launch_tasks: set = set()
        self.launches = 0  # batched kernel launches (observability)
        self.jobs_coalesced = 0
        # Last launch's shape + padding waste (observability: whether
        # the window actually coalesces, and how much of the (jobs, K,
        # P) stack was real data).
        self.last_batch_jobs = 0
        self.last_batch_k = 0
        self.last_batch_p = 0
        self.last_pad_frac = 0.0

    async def submit(
        self, cols: columnar.MergeColumns, run_counts: List[int]
    ) -> np.ndarray:
        """Returns the merged permutation for this job (8B-prefix order;
        ties resolved by the caller via
        columnar.fixup_and_dedup_prefix)."""
        if len(cols) == 0:
            return np.zeros(0, np.int64)
        loop = asyncio.get_event_loop()
        fut: asyncio.Future = loop.create_future()
        self._pending.append((cols, run_counts, fut))
        if len(self._pending) >= self.max_batch:
            self._trigger()
        elif self._flush_task is None:
            self._flush_task = asyncio.ensure_future(
                self._flush_after_window()
            )
        return await fut

    def _trigger(self) -> None:
        if self._flush_task is not None:
            self._flush_task.cancel()
            self._flush_task = None
        task = asyncio.ensure_future(self._flush())
        self._launch_tasks.add(task)
        task.add_done_callback(self._launch_tasks.discard)

    async def _flush_after_window(self) -> None:
        try:
            await asyncio.sleep(self.window_s)
        except asyncio.CancelledError:
            return
        self._flush_task = None
        await self._flush()

    async def _flush(self) -> None:
        jobs, self._pending = self._pending, []
        if not jobs:
            return
        try:
            batch = pack_jobs(jobs)

            def run() -> np.ndarray:
                # The device→host copy blocks this executor thread
                # until the launch on its stream is done, before any
                # future is set.
                packed = bitonic.to_numpy(
                    bitonic.merge_runs_prefix_batch_kernel(
                        bitonic.to_tensor(batch.prefixes, self.device),
                        bitonic.to_tensor(batch.counts, self.device),
                        batch.out_rows,
                    )
                )
                query_kernels._persist_wake(
                    self.device, "coalesced_compaction",
                    batch_jobs=len(jobs), k=batch.k, p=batch.p,
                    kernels="K6 merge_runs_prefix_batch_kernel",
                )
                return packed

            packed = await asyncio.get_event_loop().run_in_executor(
                None, run
            )
            self.launches += 1
            self.jobs_coalesced += len(jobs)
            self.last_batch_jobs = len(jobs)
            self.last_batch_k = batch.k
            self.last_batch_p = batch.p
            self.last_pad_frac = batch.pad_frac

            # Every job's iota restarts at 0 and is packed with the
            # BATCH's P (pack_jobs pads all jobs to it).
            shift = np.uint32(batch.p.bit_length() - 1)
            mask = np.uint32(batch.p - 1)
            for j, (cols, _rc, fut) in enumerate(jobs):
                n = len(cols)
                row = packed[j, :n]
                run_ids = (row >> shift).astype(np.int64)
                pos = (row & mask).astype(np.int64)
                perm = batch.bases[j][run_ids] + pos
                if not fut.done():
                    fut.set_result(perm)
        except Exception as e:
            log.exception("coalesced merge launch failed")
            for _, _, fut in jobs:
                if not fut.done():
                    fut.set_exception(e)

    def stats(self) -> dict:
        return {
            "launches": self.launches,
            "jobs_coalesced": self.jobs_coalesced,
            "last_batch_jobs": self.last_batch_jobs,
            "last_batch_k": self.last_batch_k,
            "last_batch_p": self.last_batch_p,
            "last_pad_frac": self.last_pad_frac,
        }


# One coalescer per device: a CPU caller never shares the card's.
_defaults: Dict[object, CompactionCoalescer] = {}


def default_coalescer(device=None) -> CompactionCoalescer:
    dev = resolve_device(device)
    if dev not in _defaults:
        _defaults[dev] = CompactionCoalescer(device=dev)
    return _defaults[dev]


def stats(device=None) -> "dict | None":
    """Counters of ``device``'s process-wide coalescer (None until the
    first coalesced merge on it constructs the singleton)."""
    import torch

    c = _defaults.get(torch.device("cuda" if device is None else device))
    return None if c is None else c.stats()


class CoalescedDeviceMergeStrategy:
    """CompactionStrategy whose sort rides a shared coalescer on the
    coalescer's device.  Exposes ``merge_async`` (the LSM tree prefers
    it when present) so concurrent shard compactions rendezvous in one
    launch."""

    name = "coalesced"
    # Intra-merge latency-class hook (see CompactionStrategy.throttle;
    # this class is duck-typed, not a subclass, so it needs its own).
    throttle = None
    # GC-grace cutoff (see CompactionStrategy.tombstone_drop_before):
    # LSMTree.compact() stamps it; a directly-constructed strategy
    # defaults to "keep tombstones".
    tombstone_drop_before = None
    # Secondary-index DDL (see CompactionStrategy.index_fields).
    index_fields = None

    def __init__(
        self, coalescer: Optional[CompactionCoalescer] = None
    ) -> None:
        self.coalescer = coalescer or default_coalescer()
        self.device = self.coalescer.device

    # Sync path (e.g. recovery before a loop exists): the device
    # strategy's merge on the same device.
    def merge(self, *args, **kwargs):
        from ..ops.device_compaction import DeviceMergeStrategy

        s = DeviceMergeStrategy(self.device)
        s.throttle = self.throttle
        s.tombstone_drop_before = self.tombstone_drop_before
        s.index_fields = self.index_fields
        return s.merge(*args, **kwargs)

    async def merge_async(
        self,
        sources,
        dir_path,
        output_index,
        cache,
        keep_tombstones,
        bloom_min_size,
    ):
        from ..ops.device_compaction import DeviceMergeStrategy
        from ..storage.compaction import (
            drop_tombstones_mask,
            write_output_columnar,
        )

        loop = asyncio.get_event_loop()

        # Big merges: the partitioned pipeline (off-loop, K1/K2) beats
        # any coalesced single-shot launch; the coalescer exists for
        # many small concurrent per-shard merges.
        total = sum(getattr(s, "data_size", 0) for s in sources)
        if total >= DeviceMergeStrategy.PIPELINE_MIN_BYTES:
            from ..ops.pipeline import pipeline_merge

            result = await loop.run_in_executor(
                None,
                lambda: pipeline_merge(
                    sources,
                    dir_path,
                    output_index,
                    keep_tombstones,
                    bloom_min_size,
                    device=self.device,
                    throttle=self.throttle,
                    tombstone_drop_before=self.tombstone_drop_before,
                ),
            )
            if result is not None:
                return result

        cols = await loop.run_in_executor(
            None, columnar.load_columns, sources
        )
        run_counts = (
            np.bincount(cols.src).tolist() if len(cols) else []
        )
        perm = await self.coalescer.submit(cols, run_counts)

        def finish():
            p, keep = columnar.fixup_and_dedup_prefix(
                cols, perm, words=2
            )
            if not keep_tombstones:
                keep = keep & ~drop_tombstones_mask(
                    cols.is_tombstone[p],
                    cols.timestamp[p],
                    self.tombstone_drop_before,
                )
            order = p[keep]
            return write_output_columnar(
                cols, order, dir_path, output_index, cache,
                bloom_min_size, throttle=self.throttle,
                index_fields=self.index_fields,
            )

        return await loop.run_in_executor(None, finish)
