"""CompactionStrategy seam — pluggable merge backends.

The reference hard-codes a single-threaded k-way BinaryHeap merge
(reference src/storage_engine/lsm_tree.rs:1003-1066).  Here the
merge is a strategy (SURVEY.md §7 stage 3):

  * HeapMergeStrategy    — the reference-semantics oracle: per-entry heap
                           pop/push, streamed through EntryWriter.
  * ColumnarMergeStrategy — vectorized host path: bulk columnarize, one
                           numpy lexsort + dedup mask, range-gather, bulk
                           write.
  * DeviceMergeStrategy  — (dbeel_tpu_torch.ops.device_compaction) same
                           pipeline with the merge on the card (CUDA
                           bitonic kernels, ops/bitonic.py).
  * DistributedMergeStrategy — (dbeel_tpu_torch.parallel.dist_merge) the
                           merge as a sample sort over a mesh of cards.
  * NativeMergeStrategy  — (dbeel_tpu_torch.storage.native) the C++ k-way
                           heap merge of ``native/``.

All strategies must produce byte-identical SSTable files — golden tests
enforce it.  A strategy writes the ``compact_*`` triplet; the LSM tree
owns the journal/rename/swap choreography around it.
"""

from __future__ import annotations

import heapq
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import checksums, columnar
from .bloom import BloomFilter
from .entry import (
    COMPACT_BLOOM_FILE_EXT,
    COMPACT_DATA_FILE_EXT,
    COMPACT_INDEX_FILE_EXT,
    COMPACT_SUMS_FILE_EXT,
    ENTRY_HEADER_SIZE,
    INDEX_ENTRY,
    file_name,
)
from .entry_writer import EntryWriter
from .file_io import PageMirroringWriter
from .page_cache import PartitionPageCache
from .sstable import SSTable


@dataclass
class MergeResult:
    entry_count: int
    data_size: int
    wrote_bloom: bool


class CompactionStats:
    """Process-wide single-pass compaction/flush accounting
    : bytes read and written per background pass, and
    whether each output's ``.sums`` sidecar was emitted INLINE
    (single-pass, CRCs accumulated as bytes were written) or rebuilt
    POST-HOC (the legacy full-triplet re-read, which roughly doubled
    compaction read amplification).  ``read_amplification`` is the
    measurable claim: bytes_read / merge input bytes — ~1.0 when every
    pass is single-pass, ~2.0 when every output is re-read for its
    sidecar.  One instance per process (merges from all shards of a
    node fold in), mirrored into ``get_stats.compaction``."""

    def __init__(self) -> None:
        import threading

        self._lock = threading.Lock()
        self.merge_passes = 0
        self.flush_passes = 0
        self.bytes_read = 0
        self.bytes_written = 0
        self.merge_input_bytes = 0
        self.sidecar_inline = 0
        self.sidecar_posthoc = 0
        self.posthoc_bytes_reread = 0
        # Secondary-index maintenance: bytes of .fidx runs
        # written alongside flush/compaction outputs.  Kept OUT of
        # bytes_written/bytes_read — runs are built from the writers'
        # still-resident buffers, so they add zero data reads and
        # read_amplification stays a pure data-plane measure; their
        # cost is reported as index_maintenance_amplification.
        self.index_bytes_written = 0

    def note_merge(
        self, input_bytes: int, bytes_written: int
    ) -> None:
        """One completed merge pass: inputs are read exactly once by
        every strategy (the single-pass contract), outputs written
        once."""
        with self._lock:
            self.merge_passes += 1
            self.merge_input_bytes += int(input_bytes)
            self.bytes_read += int(input_bytes)
            self.bytes_written += int(bytes_written)

    def note_flush(self, bytes_written: int) -> None:
        with self._lock:
            self.flush_passes += 1
            self.bytes_written += int(bytes_written)

    def note_sidecar(
        self, inline: bool, reread_bytes: int = 0
    ) -> None:
        """One sidecar emitted: inline (no extra IO) or post-hoc
        (the whole freshly-written triplet re-read and summed —
        ``reread_bytes`` joins the read-amplification numerator)."""
        with self._lock:
            if inline:
                self.sidecar_inline += 1
            else:
                self.sidecar_posthoc += 1
                self.posthoc_bytes_reread += int(reread_bytes)
                self.bytes_read += int(reread_bytes)

    def note_index(self, nbytes: int) -> None:
        """One index run emitted inline with a flush/merge output."""
        with self._lock:
            self.index_bytes_written += int(nbytes)

    def stats(self) -> dict:
        from . import native as native_mod

        with self._lock:
            amp = (
                round(
                    self.bytes_read / self.merge_input_bytes, 3
                )
                if self.merge_input_bytes > 0
                else None
            )
            idx_amp = (
                round(
                    self.index_bytes_written / self.bytes_written, 4
                )
                if self.bytes_written > 0
                else None
            )
            block = {
                "merge_passes": self.merge_passes,
                "flush_passes": self.flush_passes,
                "bytes_read": self.bytes_read,
                "bytes_written": self.bytes_written,
                "merge_input_bytes": self.merge_input_bytes,
                "sidecar_inline": self.sidecar_inline,
                "sidecar_posthoc": self.sidecar_posthoc,
                "posthoc_bytes_reread": self.posthoc_bytes_reread,
                "read_amplification": amp,
                "index_bytes_written": self.index_bytes_written,
                "index_maintenance_amplification": idx_amp,
            }
        # The overlapped merge input pass: io_uring passes and serial
        # fallbacks, counted inside native/.
        overlap = native_mod.read_overlap_stats()
        block["overlapped_read_passes"] = overlap[0]
        block["serial_read_passes"] = overlap[1]
        return block


# One per process — every shard's trees fold into it, like the
# device-coalescer counters.
compaction_stats = CompactionStats()


class CompactionStrategy(ABC):
    name = "abstract"

    # Optional intra-merge throttle (server.scheduler.BgThrottle): the
    # shard attaches one per tree so long merges yield CPU to serving
    # between bounded quanta even though they run on a worker thread.
    # Strategies tick it between partitions / entry blocks / write
    # chunks; None (the default, e.g. in tests and bench) is free.
    throttle = None

    # Tombstone GC grace (gc_grace, the delete-resurrection hazard):
    # when a merge is asked to DROP tombstones, any tombstone whose
    # timestamp is >= this nanosecond cutoff is kept anyway — it is
    # younger than the window a delete needs to out-live its laggard
    # replicas (hint replay / anti-entropy could otherwise resurrect
    # the old value after the tombstone was GC'd).  None/0 = drop all
    # (reference behavior; tests/benches constructing strategies
    # directly are unchanged).  Set per merge by LSMTree.compact.
    tombstone_drop_before = None

    # Secondary-index DDL: when LSMTree.compact sets this
    # to the collection's indexed field list, the merge also emits a
    # compact_fidx index run for its output — extracted from the
    # output records while they are STILL RESIDENT in the writer
    # (zero extra data reads), never by re-reading the triplet.
    # None (the default) = no index emission.
    index_fields = None

    def _tick(self) -> None:
        t = self.throttle
        if t is not None:
            t.tick()

    @abstractmethod
    def merge(
        self,
        sources: Sequence[SSTable],
        dir_path: str,
        output_index: int,
        cache: Optional[PartitionPageCache],
        keep_tombstones: bool,
        bloom_min_size: int,
    ) -> MergeResult:
        """Merge ``sources`` (oldest→newest) into the compact_* triplet at
        ``output_index``. Bloom file written iff final data size >=
        ``bloom_min_size`` (lsm_tree.rs:1026-1034)."""


class HeapMergeStrategy(CompactionStrategy):
    """Reference-semantics oracle (lsm_tree.rs:1038-1066): min-heap by
    (key, newest-ts-first, newest-source-first); pop, write first per key,
    skip the rest; optional tombstone drop."""

    name = "heap"

    def merge(
        self,
        sources,
        dir_path,
        output_index,
        cache,
        keep_tombstones,
        bloom_min_size,
    ) -> MergeResult:
        writer = EntryWriter(
            dir_path,
            output_index,
            cache,
            data_ext=COMPACT_DATA_FILE_EXT,
            index_ext=COMPACT_INDEX_FILE_EXT,
        )
        iters = [iter(t.entries()) for t in sources]
        heap: List[Tuple] = []
        for i, it in enumerate(iters):
            for key, value, ts in it:
                # (~ts, -i): newest timestamp first, tie toward the
                # newer (higher-positioned) source.
                heapq.heappush(heap, (key, ~ts, -i, value, i))
                break
        keys: List[bytes] = []
        last_key: Optional[bytes] = None
        popped = 0
        # Index-run extraction: collected AS entries stream through
        # the writer — the values are in hand, so the run costs zero
        # re-reads even on this per-entry path.
        idx_rows: Optional[List[Tuple[int, bytes]]] = (
            [] if self.index_fields else None
        )
        run_off = 0
        while heap:
            popped += 1
            if popped % 8192 == 0:
                self._tick()
            key, _nts, _ni, value, i = heapq.heappop(heap)
            for nkey, nvalue, nts in iters[i]:
                heapq.heappush(heap, (nkey, ~nts, -i, nvalue, i))
                break
            if key == last_key:
                continue  # dedup: first occurrence was the newest
            last_key = key
            if value == b"" and not keep_tombstones:
                cutoff = self.tombstone_drop_before
                if not cutoff or (~_nts) < cutoff:
                    continue
                # gc_grace: the tombstone is younger than the grace
                # window — keep it so a laggard replica cannot
                # resurrect the deleted value.
            writer.write(key, value, ~_nts)
            keys.append(key)
            if idx_rows is not None:
                idx_rows.append((run_off, value))
            run_off += ENTRY_HEADER_SIZE + len(key) + len(value)
        data_size = writer.close()
        wrote_bloom = False
        bloom_bytes = None
        if data_size >= bloom_min_size:
            bloom = BloomFilter.with_capacity(max(1, len(keys)))
            bloom.add_batch(keys)
            bloom_bytes = _write_bloom(dir_path, output_index, bloom)
            wrote_bloom = True
        data_crcs, index_crcs = writer.page_crcs()
        checksums.write(
            dir_path,
            output_index,
            data_crcs,
            index_crcs,
            data_size,
            bloom_bytes,
            ext=COMPACT_SUMS_FILE_EXT,
        )
        if idx_rows is not None:
            from . import secondary_index as si

            si.emit_run(
                dir_path,
                output_index,
                self.index_fields,
                idx_rows,
                compact=True,
            )
        return MergeResult(writer.entries_written, data_size, wrote_bloom)


class ColumnarMergeStrategy(CompactionStrategy):
    """Vectorized host path; also the template the device strategy fills
    in (it overrides ``sort_and_dedup``)."""

    name = "columnar"

    def sort_and_dedup(
        self, cols: columnar.MergeColumns
    ) -> Tuple[np.ndarray, np.ndarray]:
        perm = columnar.sort_columns_numpy(cols)
        perm = columnar.fixup_long_key_ties(cols, perm)
        return perm, columnar.dedup_mask(cols, perm)

    def merge(
        self,
        sources,
        dir_path,
        output_index,
        cache,
        keep_tombstones,
        bloom_min_size,
    ) -> MergeResult:
        cols = columnar.load_columns(sources)
        self._tick()
        perm, keep = self.sort_and_dedup(cols)
        self._tick()
        if not keep_tombstones:
            keep = keep & ~drop_tombstones_mask(
                cols.is_tombstone[perm],
                cols.timestamp[perm],
                self.tombstone_drop_before,
            )
        order = perm[keep]
        return write_output_columnar(
            cols, order, dir_path, output_index, cache, bloom_min_size,
            throttle=self.throttle, index_fields=self.index_fields,
        )


def drop_tombstones_mask(
    is_tombstone: np.ndarray,
    timestamps: np.ndarray,
    cutoff: "int | None",
) -> np.ndarray:
    """Vectorized tombstone-drop mask honoring the gc_grace cutoff:
    True where the record is a tombstone OLD enough to GC.  Shared by
    every columnar-shaped merge path so the grace semantics can never
    diverge between backends."""
    if not cutoff:
        return is_tombstone
    return is_tombstone & (timestamps < np.uint64(max(0, cutoff)))


def write_output_columnar(
    cols: columnar.MergeColumns,
    order: np.ndarray,
    dir_path: str,
    output_index: int,
    cache: Optional[PartitionPageCache],
    bloom_min_size: int,
    throttle=None,
    index_fields=None,
) -> MergeResult:
    """Bulk-write the compact_* triplet from a surviving-record order."""
    full_sizes = cols.full_size[order].astype(np.uint64)
    data_size = int(full_sizes.sum())
    n = int(order.size)

    # Index columns: offsets are the running sum of record sizes.
    offsets = np.zeros(n, dtype=np.uint64)
    if n > 1:
        np.cumsum(full_sizes[:-1], out=offsets[1:])
    index_arr = np.zeros(
        n,
        dtype=np.dtype(
            [("offset", "<u8"), ("key_size", "<u4"), ("full_size", "<u4")]
        ),
    )
    index_arr["offset"] = offsets
    index_arr["key_size"] = cols.key_size[order]
    index_arr["full_size"] = cols.full_size[order]

    data_arr = columnar.gather_records_array(cols, order)

    from .entry import DATA_FILE_EXT, INDEX_FILE_EXT

    data_w = PageMirroringWriter(
        f"{dir_path}/{file_name(output_index, COMPACT_DATA_FILE_EXT)}",
        (DATA_FILE_EXT, output_index),
        cache,
    )
    # Chunked writes from memoryviews: avoids duplicating the (possibly
    # ~GB) gathered blob as one bytes object.
    view = memoryview(data_arr)
    chunk = 32 << 20
    for off in range(0, len(view), chunk):
        data_w.write(view[off : off + chunk])
        if throttle is not None:
            throttle.tick()
    data_w.close()
    index_w = PageMirroringWriter(
        f"{dir_path}/{file_name(output_index, COMPACT_INDEX_FILE_EXT)}",
        (INDEX_FILE_EXT, output_index),
        cache,
    )
    index_w.write(index_arr.tobytes())
    index_w.close()

    wrote_bloom = False
    bloom_bytes = None
    if data_size >= bloom_min_size:
        key_pos = columnar.ranges_to_positions(
            cols.start[order] + np.uint64(ENTRY_HEADER_SIZE),
            cols.key_size[order],
        )
        key_blob = cols.data[key_pos].tobytes()
        key_sizes = cols.key_size[order]
        bounds = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(key_sizes, out=bounds[1:])
        keys = [
            key_blob[bounds[i] : bounds[i + 1]] for i in range(n)
        ]
        bloom = BloomFilter.with_capacity(max(1, n))
        bloom.add_batch(keys)
        bloom_bytes = _write_bloom(dir_path, output_index, bloom)
        wrote_bloom = True
    checksums.write(
        dir_path,
        output_index,
        data_w.page_crcs,
        index_w.page_crcs,
        data_size,
        bloom_bytes,
        ext=COMPACT_SUMS_FILE_EXT,
    )
    if index_fields:
        # Index run sliced straight out of the gathered output blob
        # still resident in RAM — zero re-reads.
        from . import secondary_index as si

        si.emit_run(
            dir_path,
            output_index,
            index_fields,
            si.rows_from_blob(data_arr, index_arr, n),
            compact=True,
        )
    return MergeResult(n, data_size, wrote_bloom)


def _write_bloom(
    dir_path: str, output_index: int, bloom: BloomFilter
) -> bytes:
    path = f"{dir_path}/{file_name(output_index, COMPACT_BLOOM_FILE_EXT)}"
    import os

    blob = bloom.serialize()
    with open(path, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    return blob


def _several_cards(dev) -> bool:
    """More than one card is visible and the caller named none."""
    import torch

    return (
        dev.type == "cuda" and dev.index is None
        and torch.cuda.device_count() > 1
    )


def get_strategy(name: str, device=None) -> CompactionStrategy:
    """Resolve a strategy by config name (config.compaction_backend).

    ``native`` is the C++ k-way merge (storage/native.py); it raises
    when the native library cannot be built.
    ``device``, ``device_full``, ``auto``, ``coalesced`` and
    ``distributed`` merge on the card — ``device`` (default ``"cuda"``)
    names it; ``"cpu"`` selects the kernels' plain PyTorch versions.
    ``coalesced`` shares the device's process-wide coalescer
    (server/coalescer.py).  ``distributed`` is the sample sort over a
    mesh of every visible card when there is more than one, else
    ``device``; ``auto`` resolves to ``distributed`` on several cards
    and to ``device`` on one (dbeel_tpu/storage/compaction.py:543-584).
    With no card and no ``"cpu"`` they raise: there is no silent
    fallback to a host merge."""
    if name == "heap":
        return HeapMergeStrategy()
    if name == "cpu" or name == "columnar":
        return ColumnarMergeStrategy()
    if name in ("device", "device_full", "auto", "distributed"):
        from ..ops._cuda import resolve_device
        from ..ops.device_compaction import (
            DeviceFullMergeStrategy,
            DeviceMergeStrategy,
        )

        dev = resolve_device(device)
        if name in ("auto", "distributed") and _several_cards(dev):
            from ..parallel.dist_merge import DistributedMergeStrategy
            from ..parallel.mesh import shard_mesh

            return DistributedMergeStrategy(shard_mesh())
        if name == "device_full":
            return DeviceFullMergeStrategy(dev)
        return DeviceMergeStrategy(dev)
    if name == "coalesced":
        from ..server.coalescer import (
            CoalescedDeviceMergeStrategy,
            default_coalescer,
        )

        return CoalescedDeviceMergeStrategy(default_coalescer(device))
    if name == "native":
        from . import native

        native.require()
        return native.NativeMergeStrategy()
    raise ValueError(f"unknown compaction backend {name!r}")
