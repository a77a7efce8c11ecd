"""Per-shard background tasks: the compaction decision.

Holds the size-tiered grouping a shard's compaction loop runs over its
tree (dbeel_tpu/server/tasks.py ``compact_tree``, after the reference's
compaction.rs:13-153).  The loop itself, the share scheduler and the
other shard tasks come with the server slice of the port (ROADMAP.md).
"""

from __future__ import annotations

import logging

log = logging.getLogger(__name__)

MIN_COMPACTION_FACTOR = 2  # compaction.rs:13


def _leading_zeros64(n: int) -> int:
    return 64 - n.bit_length() if n else 64


async def compact_tree(tree, compaction_factor: int) -> None:
    """Size-tiered grouping by size order (leading_zeros) with cascade
    merge of adjacent orders (compaction.rs:35-102); each group of at
    least ``compaction_factor`` tables is merged by ``tree.compact``."""
    indices_and_sizes = tree.sstable_indices_and_sizes()

    odd = [i for i, _ in indices_and_sizes if i % 2 != 0]
    index_to_compact = (max(odd) + 2) if odd else 1

    groups: dict = {}
    for i, size in indices_and_sizes:
        groups.setdefault(_leading_zeros64(size), []).append((i, size))

    # Largest sstables first (smallest leading_zeros first).
    ordered = sorted(groups.items())
    optimized: dict = {}
    for size_order, items in ordered:
        if size_order in optimized:
            items = items + optimized.pop(size_order)
        estimated = _leading_zeros64(sum(s for _, s in items))
        target = min(estimated, size_order)
        optimized.setdefault(target, []).extend(items)

    for i, items in enumerate(optimized.values()):
        if len(items) < MIN_COMPACTION_FACTOR or len(
            items
        ) < compaction_factor:
            continue
        indices = [idx for idx, _ in items]
        # Drop tombstones only on the final (largest) level
        # (compaction.rs:90-92).
        keep_tombstones = i > 0
        try:
            await tree.compact(indices, index_to_compact, keep_tombstones)
        except Exception as e:
            log.error("failed to compact files: %s", e)
        index_to_compact += 2
