"""DeviceMergeStrategy — compaction with the merge on the card.

Drops into the CompactionStrategy seam (storage/compaction.py): the host
stages columns (storage/columnar.py), the card runs the bitonic merge
(ops/bitonic.py, CUDA kernels in csrc/bitonic.cu), and the host finishes
with the tie refinement, the variable-length record gather and the file
writes.  Output bytes are identical to the heap and columnar strategies
(golden-tested against both and against dbeel_tpu).

``device`` is a ``torch.device``: ``cuda`` launches the kernels, ``cpu``
runs their plain PyTorch versions.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..storage import columnar
from ..storage.compaction import ColumnarMergeStrategy
from .bitonic import device_merge_prefix_order, device_merge_sorted_runs


class DeviceMergeStrategy(ColumnarMergeStrategy):
    """Default device path: the transfer-minimal 8-byte-prefix bitonic
    merge + host tie refinement.  Fully general — any prefix tie (same
    key, shared prefix, long keys) is re-ordered and dedup-confirmed on
    the host with full-key compares.  Keyspaces where many keys share
    one 8-byte prefix (e.g. everything under b"user:...") would push
    that refinement into interpreted Python, so past a tie threshold
    the merge re-routes to the full 16-byte-column device path (K4)."""

    name = "device"

    # Above this fraction of adjacent 8-byte-prefix ties, re-sort on the
    # device with full key columns rather than fix up row-by-row on host.
    TIE_FALLBACK_FRACTION = 0.02

    # Merges below this input size stay on the single-shot path; larger
    # merges go through the partitioned native pipeline (ops/pipeline.py),
    # which handles tie-heavy keyspaces internally and declines (None)
    # only when an equal-prefix group exceeds the kernel rows.
    PIPELINE_MIN_BYTES = 64 << 20

    def __init__(self, device="cuda") -> None:
        self.device = torch.device(device)

    def merge(
        self,
        sources,
        dir_path,
        output_index,
        cache,
        keep_tombstones,
        bloom_min_size,
    ):
        """Partitioned native pipeline for big merges (ops/pipeline.py:
        O_DIRECT reads, per-partition kernel launches, C++ gather +
        O_DIRECT streaming writes, all stages overlapped); otherwise
        the single-shot path with per-run upload/read overlap.

        Only the single-shot path emits a ``compact_fidx`` index run
        (``index_fields``); the pipeline writes none, as in dbeel_tpu,
        and the planner then treats that table's rows as candidates."""
        total = sum(getattr(s, "data_size", 0) for s in sources)
        if total >= self.PIPELINE_MIN_BYTES:
            from .pipeline import pipeline_merge

            result = pipeline_merge(
                sources,
                dir_path,
                output_index,
                keep_tombstones,
                bloom_min_size,
                device=self.device,
                throttle=self.throttle,
                tombstone_drop_before=self.tombstone_drop_before,
            )
            if result is not None:
                return result
        return self._merge_single_shot(
            sources,
            dir_path,
            output_index,
            cache,
            keep_tombstones,
            bloom_min_size,
        )

    def _merge_single_shot(
        self,
        sources,
        dir_path,
        output_index,
        cache,
        keep_tombstones,
        bloom_min_size,
    ):
        """Per-run device uploads overlap the disk reads (each file
        read once), then the shared finish path."""
        from ..storage.compaction import (
            drop_tombstones_mask,
            write_output_columnar,
        )
        from .bitonic import device_merge_prefix_order_pipelined

        perm, pieces = device_merge_prefix_order_pipelined(
            sources, self.device
        )
        cols = columnar.assemble_columns(pieces)
        self._tick()
        perm, keep = self._refine(cols, perm)
        self._tick()
        if not keep_tombstones:
            keep = keep & ~drop_tombstones_mask(
                cols.is_tombstone[perm],
                cols.timestamp[perm],
                self.tombstone_drop_before,
            )
        return write_output_columnar(
            cols, perm[keep], dir_path, output_index, cache,
            bloom_min_size, throttle=self.throttle,
            index_fields=self.index_fields,
        )

    def _refine(self, cols, perm):
        if len(cols) > 1:
            kw = cols.key_words[perm]
            ties = int(
                np.all(kw[1:, :2] == kw[:-1, :2], axis=1).sum()
            )
            if ties > max(
                1024, self.TIE_FALLBACK_FRACTION * len(cols)
            ):
                return DeviceFullMergeStrategy.sort_and_dedup(
                    self, cols
                )
        return columnar.fixup_and_dedup_prefix(cols, perm, words=2)

    def sort_and_dedup(
        self, cols: columnar.MergeColumns
    ) -> Tuple[np.ndarray, np.ndarray]:
        # Non-pipelined entry (pre-staged columns).
        run_counts = (
            np.bincount(cols.src).tolist() if len(cols) else []
        )
        perm = device_merge_prefix_order(cols, run_counts, self.device)
        return self._refine(cols, perm)


class DeviceFullMergeStrategy(ColumnarMergeStrategy):
    """All-columns device path: ships the full 9-column stack (16B key
    prefix, key_len, ~ts, ~src, idx) and orders everything on the card
    (K4).  More device work and ~4.5x the upload of the prefix path —
    preferable when keys cluster under shared 8-byte prefixes."""

    name = "device_full"

    def __init__(self, device="cuda") -> None:
        self.device = torch.device(device)

    def sort_and_dedup(
        self, cols: columnar.MergeColumns
    ) -> Tuple[np.ndarray, np.ndarray]:
        run_counts = (
            np.bincount(cols.src).tolist() if len(cols) else []
        )
        perm, same = device_merge_sorted_runs(cols, run_counts, self.device)
        # Keys longer than the 16-byte device prefix both alias (equal
        # prefix+len ≠ equal key) and mis-order (the length column is not
        # lexicographic across different-length same-prefix keys): any
        # long key means the host re-sorts prefix-tie blocks and redoes
        # the dedup mask.  No-op when all keys fit the prefix.
        if (cols.key_size > columnar.KEY_PREFIX_BYTES).any():
            perm = columnar.fixup_long_key_ties(cols, perm)
            return perm, columnar.dedup_mask(cols, perm)
        return perm, ~same
