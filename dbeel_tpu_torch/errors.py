"""Error taxonomy — the subset the storage and query slices raise.

Same kind names as ``dbeel_tpu.errors`` (the stable wire names of the
reference, reference src/error.rs:8-74), so a later server slice
can send them unchanged.
"""

from __future__ import annotations

from typing import Any, List


class DbeelError(Exception):
    """Base error. ``kind`` is the stable wire name."""

    kind = "Internal"

    def to_wire(self) -> List[Any]:
        return [self.kind, str(self)]


def _mk(kind_name: str, doc: str) -> type:
    return type(
        kind_name, (DbeelError,), {"kind": kind_name, "__doc__": doc}
    )


MemtableCapacityReached = _mk(
    "MemtableCapacityReached", "Memtable is at capacity."
)
CorruptedFile = _mk("CorruptedFile", "On-disk structure failed validation.")
TooManyWalFiles = _mk(
    "TooManyWalFiles", "More than two WAL files found on open."
)
ShardDegraded = _mk(
    "ShardDegraded",
    "The shard's disk failed (EIO/ENOSPC on the WAL); it is serving "
    "reads only — retry the write on another replica.",
)
BadFieldType = _mk("BadFieldType", "Request field has the wrong type.")
