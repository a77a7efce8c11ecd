"""LSM tree — the single-shard storage engine.

Role parity with reference src/storage_engine/lsm_tree.rs:
memtable(active + flushing) / WAL / SSTable(data+index+bloom) triplets;
get via memtables → bloom → per-sstable binary search newest→oldest;
set → WAL (page-padded record) + memtable with auto-flush at capacity;
pluggable merge compaction (strategy seam; the default is
``get_strategy("auto", device=device)``, on the card unless
``device="cpu"``, and it raises without one — or pass a strategy such
as ``"heap"``) with tombstone drop on the bottom level; crash safety
via (1) WAL replay, (2) the two-WAL flush protocol, (3) an idempotent
compact-action journal; reader-drain before input deletion.
``memtable_kind="hash"`` orders each memtable once at flush with the
device sort (ops/sort.py, K5) on the same ``device``.

Index numbering follows the reference: flushed sstables take even indices
0,2,4,…; a flush first creates WAL index+2, writes sstable ``index``,
then deletes WAL ``index`` (lsm_tree.rs:854-921); compaction outputs take
``max(inputs)+1`` (odd), which ranks them correctly between the remaining
older and newer tables.

``memtable_kind="arena"`` (and ``"auto"`` once ``native/`` is built)
keeps the memtable in the C++ arena, whose flush is one native call.

The port has open/recover, set/delete/get, flush (sorted, hash and
arena memtables), compact (with the coalescer's ``merge_async``), the
journal, and the scan methods: ``iter``, ``scan_page`` and
``scan_filter_page`` over a cached columnar ``ScanStage`` whose
numeric filter leaves run on the tree's ``device`` (ops/query_kernels,
K8).  With ``index_fields`` every flush and compaction also writes a
``.fidx`` index run of those value fields (storage/secondary_index.py),
and ``scan_filter_page`` plans a selective predicate on the runs (eval
path ``"indexed"``).  The digest methods of dbeel_tpu's LSMTree are a
later slice (ROADMAP.md).
"""

from __future__ import annotations

import asyncio
import errno
import functools
import logging
import os
import re
import shutil
from typing import AsyncIterator, Callable, List, Optional, Sequence, Tuple

import numpy as np

from .. import flow_events
from ..errors import (
    CorruptedFile,
    MemtableCapacityReached,
    ShardDegraded,
    TooManyWalFiles,
)
from ..utils import msgpack_codec
from ..utils.event import LocalEvent
from ..utils.timestamps import now_nanos
from . import checksums
from . import file_io
from . import journal
from . import wal as wal_mod
from .bloom import BloomFilter
from .compaction import CompactionStrategy, get_strategy
from .entry import (
    BLOOM_FILE_EXT,
    COMPACT_ACTION_FILE_EXT,
    COMPACT_BLOOM_FILE_EXT,
    COMPACT_DATA_FILE_EXT,
    COMPACT_FIDX_FILE_EXT,
    COMPACT_FIDX_SUMS_FILE_EXT,
    COMPACT_INDEX_FILE_EXT,
    COMPACT_SUMS_FILE_EXT,
    DATA_FILE_EXT,
    FIDX_FILE_EXT,
    FIDX_SUMS_FILE_EXT,
    INDEX_FILE_EXT,
    MEMTABLE_FILE_EXT,
    SUMS_FILE_EXT,
    TOMBSTONE,
    file_name,
)
from .entry_writer import EntryWriter
from .memtable import ArenaMemtable, HashMemtable, Memtable
from .page_cache import PartitionPageCache
from .sstable import SSTable

log = logging.getLogger(__name__)

DEFAULT_TREE_CAPACITY = 8192  # reference mod.rs:18
DEFAULT_BLOOM_MIN_SIZE = 1 << 20

_FILE_RE = re.compile(r"^(\d{20})\.(\w+)$")

# Free-space floors (overridable for tests / tiny hosts): a flush or
# compaction that would fill the disk backs off instead of half-writing
# a triplet and cascading into ENOSPC quarantines.
MIN_FREE_BYTES = int(
    os.environ.get("DBEEL_MIN_FREE_BYTES", str(32 << 20))
)
QUARANTINE_DIR = "quarantine"

# Errnos that mean the DISK (not the caller) failed — the degraded-mode
# escalation set.
_DISK_ERRNOS = frozenset(
    {errno.EIO, errno.ENOSPC, errno.EROFS, errno.EDQUOT}
)


class SSTableList:
    """Refcounted sstable vector: compaction swaps the list and waits
    until readers drain before deleting inputs (lsm_tree.rs:1141-1145)."""

    def __init__(self, tables: List[SSTable]) -> None:
        self.tables = sorted(tables, key=lambda t: t.index)
        self.readers = 0
        self.drained = LocalEvent()

    def acquire(self) -> None:
        self.readers += 1

    def release(self) -> None:
        self.readers -= 1
        if self.readers == 0:
            self.drained.notify()


class ScanSnapshot:
    """Point-in-time scan view (see LSMTree.scan_snapshot)."""

    def __init__(self, memtable_items, sstables: SSTableList) -> None:
        self.memtable_items = memtable_items
        self._sstables = sstables
        self._released = False

    @property
    def tables(self):
        return self._sstables.tables

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._sstables.release()


class LSMTree:
    def __init__(
        self,
        dir_path: str,
        cache: Optional[PartitionPageCache] = None,
        capacity: int = DEFAULT_TREE_CAPACITY,
        wal_sync: bool = False,
        wal_sync_delay_us: int = 0,
        bloom_min_size: int = DEFAULT_BLOOM_MIN_SIZE,
        strategy: Optional[CompactionStrategy] = None,
        memtable_kind: str = "sorted",
        gc_grace_s: float = 0.0,
        index_fields: Optional[list] = None,
        device=None,
    ) -> None:
        # "sorted" = SortedDict kept ordered per insert; "hash" = O(1)
        # dict, ordered once at flush by the device sort (ops/sort.py,
        # K5) on ``device`` — ``cuda`` unless the caller names ``cpu``;
        # "arena" = the C++ arena red-black tree of native/, which
        # writes its own flush; "auto" = "arena" when the native library
        # is already built, else "sorted" (dbeel_tpu's resolution).  An
        # arena memtable raises when the library cannot be built.
        if memtable_kind not in ("auto", "sorted", "hash", "arena"):
            raise ValueError(
                f"memtable_kind must be 'auto', 'sorted', 'hash' or "
                f"'arena', got {memtable_kind!r}"
            )
        from . import native

        if memtable_kind == "auto":
            memtable_kind = (
                "arena" if native.load_if_built() is not None else "sorted"
            )
        if memtable_kind == "hash":
            from ..ops._cuda import resolve_device

            self._memtable_cls = functools.partial(
                HashMemtable, device=resolve_device(device)
            )
        elif memtable_kind == "arena":
            self._memtable_cls = ArenaMemtable
        else:
            self._memtable_cls = Memtable
        self.dir_path = dir_path
        # Secondary-index DDL: value fields whose per-table index runs
        # the flush/compaction writers emit inline and the scan planner
        # consults.  None/empty = no index maintenance.
        self.index_fields = list(index_fields) if index_fields else None
        self.cache = cache
        self.capacity = capacity
        self.wal_sync = wal_sync
        self.wal_sync_delay_us = wal_sync_delay_us
        self.bloom_min_size = bloom_min_size
        # Tombstone GC grace (delete-resurrection hazard): a
        # drop-tombstones compaction keeps any tombstone younger than
        # this window.  0 = reference behavior (drop all at the bottom
        # level).
        self.gc_grace_s = gc_grace_s
        # No strategy: compaction on ``device``, the card by default
        # (raises without one).
        self.strategy = strategy or get_strategy("auto", device=device)
        # Where the scan stage's filter kernels run (None = the card;
        # resolved at the first numeric leaf that reaches a kernel).
        self.device = device
        # The cached scan stage of the current tree state, its state
        # token and the sstable list it holds one reader ref on.
        self._scan_stage = None
        self._scan_stage_key: Optional[tuple] = None
        self._scan_stage_list: Optional[SSTableList] = None
        # Secondary-index runs: table index -> IndexRun (or None for
        # absent/torn), loaded lazily off-loop by the scan planner;
        # invalidated with the scan stage.  Quarantined run indices
        # never reload until the table itself turns over.
        self._index_runs: dict = {}
        self._fidx_quarantined: set = set()
        self.memtable_kind = memtable_kind
        self._active = self._memtable_cls(capacity)
        # WAL appends into the active memtable since its last swap —
        # the update-heavy flush trigger (see set_with_timestamp).
        self._appends_since_swap = 0
        # Newest timestamp that may exist in a FLUSHED layer
        # (conservative: stamped with wall clock at each swap and at
        # recovery).  Explicit-timestamp writes at or below it must
        # take a read-guarded apply path: point reads resolve by LAYER
        # order (first match), so inserting an OLDER-ts version into a
        # fresh memtable above a flushed newer one would serve the
        # stale value until compaction.
        self.max_flushed_ts = 0
        self._flushing: Optional[Memtable] = None
        self._sstables = SSTableList([])
        self._wal: Optional[wal_mod.Wal] = None
        self._index = 0  # next flush sstable index (even)
        self._is_flushing = False
        # (flush_index, old_wal) of a swap whose sstable write hasn't
        # committed yet; survives a failed attempt so the next flush()
        # retries it instead of clobbering the flushing memtable.
        self._pending_flush: Optional[Tuple[int, wal_mod.Wal]] = None
        self._disposing_wal: Optional[wal_mod.Wal] = None

        # Durability plane: WAL EIO/ENOSPC flips the tree read-only —
        # writes raise ShardDegraded while reads keep serving.
        self.read_only = False
        # Escalation hooks for an owning shard: disk errors, a
        # quarantine, and every acked mutation (key, value, timestamp).
        self.on_disk_error: Optional[Callable] = None
        self.on_quarantine: Optional[Callable] = None
        self.on_commit: Optional[Callable] = None
        self.durability = {
            "checksum_failures": 0,
            "quarantined_tables": 0,
            "repairs_completed": 0,
        }
        self._quarantined_indices: set = set()
        # Quarantines not yet covered by a completed repair: while
        # non-zero, a local miss is SUSPECT.
        self._quarantine_pending = 0
        # Highest PENDING quarantined index: any surviving-table hit
        # from a LOWER index is equally suspect under single-evidence
        # reads.
        self._suspect_max_index = -1
        # In-flight quarantine file moves (reader-drain + os.replace).
        self._retire_tasks: set = set()

        self.flush_start_event = LocalEvent()
        self.flush_done_event = LocalEvent()
        self.flow = flow_events.FlowEventNotifier()
        # Serving-data-plane hook: called with this tree whenever the
        # write state (active/flushing memtable, WAL, table list, a
        # table's warmed read index) changes, so the native fast path
        # re-registers fresh handles.
        self.write_state_listener: Optional[Callable] = None

    # ------------------------------------------------------------------
    # Open / recovery (lsm_tree.rs:401-545)
    # ------------------------------------------------------------------

    @classmethod
    def open_or_create(cls, dir_path: str, **kwargs) -> "LSMTree":
        tree = cls(dir_path, **kwargs)
        tree._open()
        return tree

    def _scan_dir(self):
        by_ext: dict = {}
        for name in os.listdir(self.dir_path):
            m = _FILE_RE.match(name)
            if m:
                by_ext.setdefault(m.group(2), []).append(int(m.group(1)))
        return by_ext

    def _open(self) -> None:
        os.makedirs(self.dir_path, exist_ok=True)

        # (1) Idempotent compact-action journal replay (424-438).
        for name in sorted(os.listdir(self.dir_path)):
            if name.endswith("." + COMPACT_ACTION_FILE_EXT):
                self._replay_compact_action(
                    os.path.join(self.dir_path, name)
                )

        # Orphaned compact_* outputs (crash before the journal was
        # written) are garbage: delete them.
        for name in os.listdir(self.dir_path):
            m = _FILE_RE.match(name)
            if m and m.group(2) in (
                COMPACT_DATA_FILE_EXT,
                COMPACT_INDEX_FILE_EXT,
                COMPACT_BLOOM_FILE_EXT,
                COMPACT_SUMS_FILE_EXT,
                COMPACT_FIDX_FILE_EXT,
                COMPACT_FIDX_SUMS_FILE_EXT,
            ):
                os.unlink(os.path.join(self.dir_path, name))

        by_ext = self._scan_dir()
        data_indices = sorted(
            set(by_ext.get(DATA_FILE_EXT, []))
            & set(by_ext.get(INDEX_FILE_EXT, []))
        )
        wal_indices = sorted(by_ext.get(MEMTABLE_FILE_EXT, []))

        if len(wal_indices) > 2:
            raise TooManyWalFiles(
                f"{len(wal_indices)} WAL files in {self.dir_path}"
            )

        # (2) Two-WAL flush protocol (478-513): two WALs mean a flush of
        # the older one was interrupted — complete it now.
        if len(wal_indices) == 2:
            older, newer = wal_indices
            if newer != older + 2:
                raise CorruptedFile(
                    f"unexpected WAL pair {wal_indices} in {self.dir_path}"
                )
            recovered = Memtable(max(self.capacity, 1 << 30))
            try:
                for key, value, ts in wal_mod.replay(
                    self._wal_path(older)
                ):
                    recovered.set(key, value, ts)
            except FileNotFoundError:
                # An in-process close->reopen can race the previous
                # instance's off-loop disposal: the retired WAL
                # vanished between our listing and this open.  Only
                # disposal unlinks WALs, and it runs strictly after
                # the flush commit — the contents are already durable
                # in an sstable, so there is nothing to recover.
                # (replay streams from an open fd, so a mid-iteration
                # vanish is impossible; the race is open-time only.)
                recovered = Memtable(1)
            if len(recovered):
                self._write_sstable_from_items(
                    older, recovered.sorted_items()
                )
                if older not in data_indices:
                    data_indices.append(older)
                    data_indices.sort()
            try:
                os.unlink(self._wal_path(older))
            except FileNotFoundError:
                pass  # the racing disposal beat us to it
            wal_indices = [newer]

        # (3) Load sstables.
        self._sstables = SSTableList(
            [
                SSTable(
                    self.dir_path, i, self.cache,
                    counters=self.durability,
                )
                for i in data_indices
            ]
        )

        # (4) WAL replay into the active memtable (552-574).
        if wal_indices:
            self._index = wal_indices[0]
            replayed = Memtable(max(self.capacity, 1 << 30))
            replay_appends = 0
            for key, value, ts in wal_mod.replay(
                self._wal_path(self._index)
            ):
                replayed.set(key, value, ts)
                replay_appends += 1
            self._active = self._memtable_cls(
                max(self.capacity, len(replayed) + 1)
            )
            for key, (value, ts) in replayed.items():
                self._active.set(key, value, ts)
            # The replayed WAL can hold far more appends than live
            # keys (the very workload the append trigger bounds):
            # carry its append count so a post-recovery write flushes
            # promptly instead of growing this WAL further.
            self._appends_since_swap = replay_appends
        else:
            self._index = (
                (max(data_indices) // 2 + 1) * 2 if data_indices else 0
            )
        self._wal = wal_mod.Wal(
            self._wal_path(self._index),
            sync=self.wal_sync,
            sync_delay_us=self.wal_sync_delay_us,
            on_error=self._report_disk_error,
        )
        if data_indices or wal_indices:
            # Anything recovered from disk may hold entries up to
            # "now" (or beyond, under clock skew — cover the replayed
            # WAL's real newest ts); later old-ts writes must go
            # read-guarded.
            self.max_flushed_ts = max(
                now_nanos(),
                self._active.max_ts,
            )
        self._notify_write_state()

    def _wal_path(self, index: int) -> str:
        return os.path.join(
            self.dir_path, file_name(index, MEMTABLE_FILE_EXT)
        )

    def _replay_compact_action(self, path: str) -> None:
        try:
            with open(path, "rb") as f:
                action = journal.unpackb(f.read())
        except Exception:
            os.unlink(path)  # torn journal write: compaction never
            return  # committed; inputs are all still live.
        for src, dst in action.get("renames", []):
            if os.path.exists(src):
                os.replace(src, dst)
        for victim in action.get("deletes", []):
            if os.path.exists(victim):
                os.unlink(victim)
        os.unlink(path)

    # ------------------------------------------------------------------
    # Durability plane: disk-error escalation + corruption quarantine
    # ------------------------------------------------------------------

    def _report_disk_error(self, e: BaseException) -> None:
        """Escalate a disk-level failure (WAL append/fsync EIO/ENOSPC,
        flush/compaction out of space): flip this tree read-only and
        tell the shard so it degrades the whole serving plane instead
        of dying mid-pipeline.  Always called on the loop thread."""
        if isinstance(e, OSError) and (
            e.errno is not None and e.errno not in _DISK_ERRNOS
        ):
            return  # EBADF during a close race etc. — not the disk
        first = not self.read_only
        self.read_only = True
        if first:
            log.error(
                "disk failure on %s: entering read-only degraded "
                "mode (%s)",
                self.dir_path,
                e,
            )
            self.flow.notify(flow_events.FlowEvent.SHARD_DEGRADED)
        if self.on_disk_error is not None:
            try:
                self.on_disk_error(e)
            except Exception:
                log.exception("on_disk_error callback failed")

    async def rearm_precheck(self) -> None:
        """Admin ``rearm`` pre-checks (operator replaced the disk):
        prove this store's filesystem is writable again — free space
        back above the flush floor, plus a write+fsync round trip
        through the same fault seam the WAL append path uses —
        WITHOUT clearing read-only (the shard layer does, once every
        collection's tree passes).  Raises ShardDegraded while the
        disk is still bad.  The probe uses a scratch file, not the
        live WAL: a post-EIO WAL fd may be stale regardless, and the
        flush the shard spawns right after re-arming rotates to a
        fresh WAL anyway (two-WAL protocol) — if THAT still fails,
        the on_error hook re-degrades immediately."""
        probe = os.path.join(self.dir_path, ".rearm-probe")
        if file_io.free_disk_space(probe) < MIN_FREE_BYTES:
            raise ShardDegraded(
                f"rearm {self.dir_path}: still below the "
                f"free-space floor"
            )

        def _probe_write() -> None:
            file_io.check_write_fault(probe)
            fd = os.open(
                probe, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644
            )
            try:
                os.write(fd, b"\x00" * 4096)
                os.fsync(fd)
            finally:
                os.close(fd)
                try:
                    os.unlink(probe)
                except OSError:
                    pass

        try:
            await asyncio.get_event_loop().run_in_executor(
                None, _probe_write
            )
        except OSError as e:
            raise ShardDegraded(
                f"rearm {self.dir_path}: WAL-append probe failed: {e}"
            ) from e

    @property
    def reads_suspect(self) -> bool:
        """True while a quarantine awaits repair: a local miss may be
        LOST data, not a genuine absence — callers answering clients
        from this tree alone must error (retryable) instead."""
        return self._quarantine_pending > 0

    def quarantine_table(self, table: SSTable, reason: str) -> None:
        """Contain a corrupt table: drop it from the read set NOW
        (synchronously — the very next probe must not touch it), purge
        its page-cache entries, and move its files aside off-loop once
        in-flight readers drain.  Never unlinks: retiring the
        quarantined triplet after a replica repair belongs to the
        server slice of the port."""
        if table.index in self._quarantined_indices:
            return
        self._quarantined_indices.add(table.index)
        self.durability["quarantined_tables"] += 1
        self._quarantine_pending += 1
        self._suspect_max_index = max(
            self._suspect_max_index, table.index
        )
        log.error(
            "quarantining sstable %d of %s: %s",
            table.index,
            self.dir_path,
            reason,
        )
        old_list = self._sstables
        self._sstables = SSTableList(
            [t for t in old_list.tables if t.index != table.index]
        )
        if self.cache is not None:
            # A recycled (ext, index) file id must never serve the
            # corrupt (or merely stale) pages.
            self.cache.invalidate_file((DATA_FILE_EXT, table.index))
            self.cache.invalidate_file((INDEX_FILE_EXT, table.index))
        self._notify_write_state()
        retire = asyncio.ensure_future(
            self._retire_quarantined_files(old_list, table)
        )
        self._retire_tasks.add(retire)
        retire.add_done_callback(self._retire_tasks.discard)
        if self.on_quarantine is not None:
            try:
                self.on_quarantine(self)
            except Exception:
                log.exception("on_quarantine callback failed")
        self.flow.notify(flow_events.FlowEvent.TABLE_QUARANTINED)

    def _handle_table_corruption(
        self, table: SSTable, exc: BaseException
    ) -> None:
        self.durability["checksum_failures"] += 1
        self.quarantine_table(table, str(exc))

    def quarantine_by_exception(self, exc, tables) -> bool:
        """Attribute a bulk-read CorruptedFile to its source table by
        the ``.path`` the verifier stamped and quarantine it — the
        compaction merge's and the scan paths' readers are
        table-agnostic.  Returns True when a victim was identified and
        quarantined."""
        bad = self._table_index_from_path(getattr(exc, "path", None))
        if bad is None:
            return False
        victim = next((t for t in tables if t.index == bad), None)
        if victim is None:
            return False
        self._handle_table_corruption(victim, exc)
        return True

    async def _retire_quarantined_files(self, old_list, table) -> None:
        # Reader drain first (same contract as compaction input
        # deletion): probes already inside the old snapshot may still
        # hold offsets into these files.
        while old_list.readers > 0:
            await old_list.drained.listen()
        table.close()
        qdir = os.path.join(self.dir_path, QUARANTINE_DIR)

        def _move():
            os.makedirs(qdir, exist_ok=True)
            for p in table.paths():
                try:
                    if os.path.exists(p):
                        os.replace(
                            p, os.path.join(qdir, os.path.basename(p))
                        )
                except OSError:
                    log.warning("quarantine move failed for %s", p)

        await asyncio.get_event_loop().run_in_executor(None, _move)

    def finish_repair(self, covered: int, recovered: bool = True) -> None:
        """A replica repair pull completed, covering ``covered``
        quarantines observed when it started: retire the quarantined
        files for good and clear the suspect-miss state.
        ``recovered=False`` (no replica existed to pull from — the
        quarantined data is lost) clears the state without counting a
        completed repair in the stats."""
        self._quarantine_pending = max(
            0, self._quarantine_pending - max(0, covered)
        )
        if self._quarantine_pending == 0:
            self._suspect_max_index = -1
        if recovered:
            self.durability["repairs_completed"] += 1
        qdir = os.path.join(self.dir_path, QUARANTINE_DIR)

        def _rm():
            try:
                for name in os.listdir(qdir):
                    os.unlink(os.path.join(qdir, name))
                os.rmdir(qdir)
            except OSError:
                pass

        # A fast repair can beat the reader-drained file move
        # (_retire_quarantined_files): deleting first would leave the
        # late-moved triplet leaking in quarantine/ forever — wait for
        # every in-flight retire before removing the dir.
        pending = [t for t in self._retire_tasks if not t.done()]

        async def _rm_after_retires():
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)
            await asyncio.get_event_loop().run_in_executor(None, _rm)

        try:
            asyncio.get_running_loop()
            asyncio.ensure_future(_rm_after_retires())
        except RuntimeError:
            _rm()
        self.flow.notify(flow_events.FlowEvent.REPAIR_DONE)

    def close(self) -> None:
        if self._wal is not None:
            self._wal.close()
        if self._disposing_wal is not None:
            # An in-process close->reopen (test harness node restarts)
            # must not leave the retired WAL's off-loop unlink racing
            # the next open()'s recovery listing.
            self._disposing_wal.join_disposed()
            self._disposing_wal = None
        self._drop_scan_stage()
        for t in self._sstables.tables:
            t.close()

    # ------------------------------------------------------------------
    # Reads (lsm_tree.rs:674-723)
    # ------------------------------------------------------------------

    def newest_memtable_ts(self, key: bytes) -> Optional[int]:
        """Newest timestamp for ``key`` across the active + flushing
        memtables, or None — a synchronous probe for callers that must
        re-check freshness with no awaits before writing."""
        newest = None
        hit = self._active.get(key)
        if hit is not None:
            newest = hit[1]
        if self._flushing is not None:
            hit = self._flushing.get(key)
            if hit is not None and (newest is None or hit[1] > newest):
                newest = hit[1]
        return newest

    async def get_entry(
        self, key: bytes, suspect_guard: bool = False
    ) -> Optional[Tuple[bytes, int]]:
        """Async point read: memtable hits return inline; sstable
        probes go through the executor-backed async read path so a
        cache-miss binary search never stalls the shard loop (reference analog: io_uring DMA reads).  The
        sstable list is refcounted across awaits so a concurrent
        compaction cannot delete tables under us (lsm_tree.rs:
        1141-1145 reader-drain semantics).

        ``suspect_guard`` (single-evidence callers: RF=1 /
        consistency=1 — quorum reads must NOT set it, their merge
        outvotes staleness by timestamp): while a quarantine awaits
        repair, a hit from a table OLDER than the quarantined one is
        reported as a miss — the dropped table may have held a newer
        value or a tombstone that would shadow it (resurrection
        hazard), and the caller's suspect-miss handling turns the
        miss into a retryable error."""
        hit = self._active.get(key)
        if hit is not None:
            return hit
        if self._flushing is not None:
            hit = self._flushing.get(key)
            if hit is not None:
                return hit
        tables_list = self._sstables
        tables_list.acquire()
        try:
            for table in reversed(tables_list.tables):
                if table.index in self._quarantined_indices:
                    continue  # snapshot taken before a quarantine
                if not table.maybe_contains(key):
                    continue
                try:
                    hit = await table.get_async(key)
                except CorruptedFile as e:
                    # Detect → contain → fall back: quarantine the
                    # table and keep probing the surviving (older)
                    # tables; the caller's replica walk covers the
                    # rest.
                    self._handle_table_corruption(table, e)
                    continue
                if hit is not None:
                    if (
                        suspect_guard
                        and self._quarantine_pending
                        and table.index < self._suspect_max_index
                    ):
                        return None  # shadow-suspect: treat as miss
                    return hit
        finally:
            tables_list.release()
        return None

    async def get(
        self, key: bytes, suspect_guard: bool = False
    ) -> Optional[bytes]:
        """Live value or None (tombstone = None)."""
        hit = await self.get_entry(key, suspect_guard=suspect_guard)
        if hit is None or hit[0] == TOMBSTONE:
            return None
        return hit[0]

    async def multi_get(
        self, keys: Sequence[bytes], suspect_guard: bool = False
    ) -> "dict[bytes, Optional[Tuple[bytes, int]]]":
        """Batched point reads: one entry per DISTINCT key (None =
        absent).  Shares the probe setup a per-key loop would pay N
        times: the memtable probes run synchronously up front, then
        ONE sstable-list acquire/release covers every remaining key,
        probed in sorted key order so adjacent keys revisit the same
        index/data pages while they are hot in the page cache."""
        out: dict = {}
        missing: List[bytes] = []
        for key in keys:
            if key in out:
                continue
            hit = self._active.get(key)
            if hit is None and self._flushing is not None:
                hit = self._flushing.get(key)
            out[key] = hit
            if hit is None:
                missing.append(key)
        if not missing:
            return out
        tables_list = self._sstables
        tables_list.acquire()
        try:
            for key in sorted(missing):
                for table in reversed(tables_list.tables):
                    if table.index in self._quarantined_indices:
                        continue
                    if not table.maybe_contains(key):
                        continue
                    try:
                        hit = await table.get_async(key)
                    except CorruptedFile as e:
                        self._handle_table_corruption(table, e)
                        continue
                    if hit is not None:
                        if (
                            suspect_guard
                            and self._quarantine_pending
                            and table.index < self._suspect_max_index
                        ):
                            break  # shadow-suspect: report a miss
                        out[key] = hit
                        break
        finally:
            tables_list.release()
        return out

    # ------------------------------------------------------------------
    # Writes (lsm_tree.rs:731-837)
    # ------------------------------------------------------------------

    async def set(self, key: bytes, value: bytes) -> None:
        await self.set_with_timestamp(key, value, now_nanos())

    async def set_with_timestamp(
        self, key: bytes, value: bytes, timestamp: int,
        stale_abort: bool = False,
        stale_abort_from: "int | None" = None,
    ) -> bool:
        """Insert (key, value, timestamp).  With ``stale_abort``,
        return False WITHOUT inserting if, at the moment of the
        actual memtable insert, ``timestamp`` is no newer than the
        flush watermark — closing the race where a capacity wait
        spans a flush swap and the pre-checked guard in the shard
        layer goes stale (the caller then applies read-guarded).
        The check sits synchronously before the insert (no awaits
        between), so it cannot itself race a swap.

        ``stale_abort_from=wm`` is the read-guarded variant (the
        apply_if_newer final insert): abort only
        when the watermark has MOVED past ``wm`` since the caller's
        probe AND covers ``timestamp`` — an already-below-watermark
        ts whose probe proved it newest for its key must still land
        (the plain flag would starve it forever), while a swap that
        raced the probe forces a re-probe against the new layers."""
        if self.read_only:
            raise ShardDegraded(
                f"{self.dir_path}: read-only (disk failure)"
            )
        while True:
            try:
                if (
                    stale_abort
                    and timestamp <= self.max_flushed_ts
                ):
                    return False
                if (
                    stale_abort_from is not None
                    and self.max_flushed_ts > stale_abort_from
                    and timestamp <= self.max_flushed_ts
                ):
                    return False
                self._active.set(key, value, timestamp)
                break
            except MemtableCapacityReached:
                # Wait for a flush to swap in a fresh memtable
                # (lsm_tree.rs:747-755).
                waiter = self.flush_start_event.listen()
                self._spawn_flush()
                await waiter
                if self.read_only:
                    # The flush we waited on backed off (out of disk):
                    # escape instead of spinning on a full memtable.
                    raise ShardDegraded(
                        f"{self.dir_path}: read-only (disk failure)"
                    )
        assert self._wal is not None
        try:
            await self._wal.append(key, value, timestamp)
        except OSError as e:
            # The memtable holds the entry but durability failed: the
            # WAL's on_error hook already flipped degraded mode —
            # surface a retryable, typed error so the client walks to
            # a replica with a working disk (timestamps make the
            # retry idempotent under LWW).
            raise ShardDegraded(
                f"WAL append failed: {e}"
            ) from e
        self._appends_since_swap += 1
        if self.on_commit is not None:
            self.on_commit(key, value, timestamp)
        # Flush on capacity DISTINCT keys (reference semantics,
        # lsm_tree.rs:747-755) — or on capacity APPENDS: an
        # update-heavy workload hammering fewer than ``capacity`` hot
        # keys never fills the memtable, so the page-padded WAL grows
        # without bound (the 17-minute chaos soak wrote a 3.6 GB WAL
        # for 240 live keys) and a crash replays all of it.  Counting
        # appends bounds WAL size and replay work while changing
        # nothing for insert-only workloads, where appends == distinct
        # keys.  The C data plane keeps its own counter for the writes
        # it serves (FastCollection::appends) — the two streams are
        # disjoint, so mixed-path traffic flushes by ~2x capacity
        # appends worst-case, still a hard bound.  The reference
        # inherits the unbounded-WAL behavior.
        if (
            self._active.is_full()
            or self._appends_since_swap >= self.capacity
        ):
            self._spawn_flush()
        return True

    async def set_batch_with_timestamp(
        self,
        entries: Sequence[Tuple[bytes, bytes, int]],
        stale_abort: bool = False,
    ) -> List[Tuple[bytes, bytes, int]]:
        """Insert a batch: memtable inserts under one capacity check
        per chunk (Memtable.set_batch), then ONE WAL append_batch per
        chunk — so a durable batch pays one fdatasync wait, not N
        (group commit).  A capacity refusal mid-batch flush-waits and
        continues with the remainder, like the single-set path.

        With ``stale_abort``, entries whose timestamp is no newer
        than the flush watermark AT INSERT TIME are skipped and
        returned (the caller applies them read-guarded) — the same
        race-closing contract as set_with_timestamp(stale_abort=True);
        the watermark check and the memtable insert have no awaits
        between them."""
        if self.read_only:
            raise ShardDegraded(
                f"{self.dir_path}: read-only (disk failure)"
            )
        rejected: List[Tuple[bytes, bytes, int]] = []
        pending = list(entries)
        while pending:
            if stale_abort:
                wm = self.max_flushed_ts
                fresh = []
                for e in pending:
                    (rejected if e[2] <= wm else fresh).append(e)
                pending = fresh
                if not pending:
                    break
            applied = self._active.set_batch(pending)
            if applied == 0:
                waiter = self.flush_start_event.listen()
                self._spawn_flush()
                await waiter
                continue
            chunk, pending = pending[:applied], pending[applied:]
            assert self._wal is not None
            try:
                await self._wal.append_batch(chunk)
            except OSError as e:
                raise ShardDegraded(
                    f"WAL batch append failed: {e}"
                ) from e
            self._appends_since_swap += applied
            if self.on_commit is not None:
                for k, v, ts in chunk:
                    self.on_commit(k, v, ts)
            if (
                self._active.is_full()
                or self._appends_since_swap >= self.capacity
            ):
                self._spawn_flush()
        return rejected

    async def delete(self, key: bytes) -> None:
        await self.set_with_timestamp(key, TOMBSTONE, now_nanos())

    async def delete_with_timestamp(self, key: bytes, timestamp: int):
        await self.set_with_timestamp(key, TOMBSTONE, timestamp)

    # ------------------------------------------------------------------
    # Flush (lsm_tree.rs:844-946)
    # ------------------------------------------------------------------

    def _spawn_flush(self) -> None:
        asyncio.ensure_future(self.flush())

    async def flush(self) -> None:
        while self._is_flushing:
            await self.flush_done_event.listen()
        if self._pending_flush is None and len(self._active) == 0:
            return
        self._is_flushing = True
        try:
            if self._pending_flush is None:
                # The previous flush's WAL disposal runs off-loop
                # (close/unlink of a dirty multi-MB file blocks for
                # tens of ms): wait it out before creating a third
                # WAL, or a crash in the window would leave >2 WALs
                # on disk and trip the recovery invariant.
                if self._disposing_wal is not None:
                    await self._disposing_wal.wait_disposed()
                    self._disposing_wal = None
                flush_index = self._index
                next_index = flush_index + 2
                # ENOSPC back-off: a flush that would fill the disk is
                # refused up front (degraded mode takes over) rather
                # than half-writing a triplet and cascading into
                # checksum quarantines of its own torn output.
                if (
                    file_io.free_disk_space(
                        self._wal_path(next_index)
                    )
                    < MIN_FREE_BYTES
                ):
                    self._report_disk_error(
                        OSError(
                            errno.ENOSPC,
                            f"flush of {self.dir_path}: below the "
                            f"free-space floor",
                        )
                    )
                    self.flush_start_event.notify()  # release waiters
                    return
                # Two-WAL protocol: the next WAL must exist before the
                # sstable write starts (lsm_tree.rs:854-873).
                try:
                    new_wal = wal_mod.Wal(
                        self._wal_path(next_index),
                        sync=self.wal_sync,
                        sync_delay_us=self.wal_sync_delay_us,
                        on_error=self._report_disk_error,
                    )
                except OSError as e:
                    self._report_disk_error(e)
                    self.flush_start_event.notify()
                    return
                assert self._wal is not None
                self._pending_flush = (flush_index, self._wal)
                self._flushing = self._active
                self._active = self._memtable_cls(self.capacity)
                self._appends_since_swap = 0
                # Conservative: wall clock, AND the swapped-out
                # memtable's real newest ts (remote-coordinator
                # timestamps can exceed local now under clock skew).
                self.max_flushed_ts = max(
                    now_nanos(),
                    self._flushing.max_ts,
                )
                self._wal = new_wal
                self._index = next_index
                self._notify_write_state()
                self.flush_start_event.notify()

            flush_index, old_wal = self._pending_flush
            flushing = self._flushing
            assert flushing is not None
            # Write off-loop: the flushing memtable is no longer
            # mutated, so the worker may read it.  An arena memtable
            # writes the triplet, bloom and .sums in one GIL-free
            # native call.
            def write():
                if getattr(flushing, "has_native_flush", False):
                    self._native_flush(flushing, flush_index)
                else:
                    self._write_sstable_from_items(
                        flush_index, flushing.sorted_items()
                    )

            try:
                await asyncio.get_event_loop().run_in_executor(None, write)
            except OSError as e:
                # Sstable write failed on the disk: keep the flushing
                # memtable + old WAL (_pending_flush retries once the
                # operator frees space / replaces the disk) and
                # degrade instead of crashing the flush task.
                self._report_disk_error(e)
                return
            table = SSTable(
                self.dir_path, flush_index, self.cache,
                counters=self.durability,
            )
            # Pre-warm the in-memory read index off-loop so the first
            # point lookup doesn't pay the bulk read; when it lands,
            # re-notify so the native data plane picks up the built
            # prefix arrays (the callback runs on the loop thread).
            asyncio.get_event_loop().run_in_executor(
                None, table.warm
            ).add_done_callback(lambda _f: self._notify_write_state())
            self._sstables = SSTableList(
                self._sstables.tables + [table]
            )
            self._flushing = None
            self._pending_flush = None
            self._notify_write_state()
            old_wal.delete()  # disposal completes off-loop
            self._disposing_wal = old_wal
        finally:
            self._is_flushing = False
            self.flush_done_event.notify()
            self.flow.notify(flow_events.FlowEvent.MEMTABLE_FLUSH_DONE)

    def _native_flush(self, memtable: ArenaMemtable, index: int) -> None:
        """The single-pass native flush of an arena memtable: the C
        writer page-CRCs every byte as it emits it, so the ``.sums``
        sidecar needs no re-read of the fresh triplet."""
        from .compaction import compaction_stats

        memtable.flush_to_sstable_with_sums(
            self.dir_path, index, self.bloom_min_size
        )
        written = 0
        for ext in (DATA_FILE_EXT, INDEX_FILE_EXT, BLOOM_FILE_EXT,
                    SUMS_FILE_EXT):
            try:
                written += os.path.getsize(
                    os.path.join(self.dir_path, file_name(index, ext))
                )
            except OSError:
                pass  # no bloom below bloom_min_size
        compaction_stats.note_sidecar(True)
        compaction_stats.note_flush(written)
        if self.index_fields:
            # The index run is extracted from the arena's RAM dump —
            # the same records the C writer just emitted — so building
            # it reads zero data-file bytes.
            from . import secondary_index as si

            nb = si.emit_run(
                self.dir_path,
                index,
                self.index_fields,
                si.rows_from_items(memtable.sorted_items()),
                compact=False,
            )
            compaction_stats.note_index(nb)

    def _write_sstable_from_items(
        self, index: int, items: Sequence[Tuple[bytes, Tuple[bytes, int]]]
    ) -> None:
        """Write a live (non-compact) sstable triplet from sorted items.
        Runs off-loop during flush: mirrors no pages (cache is loop-owned);
        the freshly-written table warms on first read instead."""
        writer = EntryWriter(self.dir_path, index, cache=None)
        data_size = sum(16 + len(k) + len(v) for k, (v, _) in items)
        bloom = (
            BloomFilter.with_capacity(max(1, len(items)))
            if data_size >= self.bloom_min_size
            else None
        )
        for key, (value, ts) in items:
            writer.write(key, value, ts)
        written = writer.close()
        bloom_bytes = None
        if bloom is not None:
            bloom.add_batch([k for k, _ in items])
            bloom_bytes = bloom.serialize()
            with open(
                os.path.join(
                    self.dir_path, file_name(index, BLOOM_FILE_EXT)
                ),
                "wb",
            ) as f:
                f.write(bloom_bytes)
                f.flush()
                os.fsync(f.fileno())
        data_crcs, index_crcs = writer.page_crcs()
        checksums.write(
            self.dir_path,
            index,
            data_crcs,
            index_crcs,
            written,
            bloom_bytes,
            ext=SUMS_FILE_EXT,
        )
        from .compaction import compaction_stats

        compaction_stats.note_sidecar(True)  # writer-tracked CRCs
        compaction_stats.note_flush(
            written
            + len(items) * 16
            + (len(bloom_bytes) if bloom_bytes is not None else 0)
        )
        # getattr: golden-writer tests drive this method on a bare
        # LSMTree.__new__ skeleton that never ran __init__.
        if getattr(self, "index_fields", None):
            # The index run comes from the same in-RAM items the writer
            # just serialized — zero data-file reads.
            from . import secondary_index as si

            nb = si.emit_run(
                self.dir_path,
                index,
                self.index_fields,
                si.rows_from_items(items),
                compact=False,
            )
            compaction_stats.note_index(nb)

    # ------------------------------------------------------------------
    # Compaction (lsm_tree.rs:950-1156)
    # ------------------------------------------------------------------

    @property
    def memtable_entries(self) -> int:
        """Entries living only in memory (active + in-flight flush)."""
        n = len(self._active)
        if self._flushing is not None:
            n += len(self._flushing)
        return n

    def sstable_indices_and_sizes(self) -> List[Tuple[int, int]]:
        return [
            (t.index, t.data_size) for t in self._sstables.tables
        ]

    def sstable_entry_count(self) -> int:
        return sum(t.entry_count for t in self._sstables.tables)

    async def compact(
        self,
        indices: Sequence[int],
        output_index: int,
        keep_tombstones: bool,
    ) -> None:
        index_set = set(indices)
        inputs = [
            t for t in self._sstables.tables if t.index in index_set
        ]
        if len(inputs) != len(index_set):
            raise ValueError(
                f"compact: missing inputs {index_set} in "
                f"{[t.index for t in self._sstables.tables]}"
            )
        if not inputs:
            return

        # ENOSPC back-off: the merge output peaks at roughly the sum
        # of its inputs before the old files are deleted — refuse up
        # front and retry on a later cycle rather than tearing a
        # half-written compact_* triplet on a full disk.
        needed = sum(t.data_size for t in inputs) + MIN_FREE_BYTES
        if file_io.free_disk_space(self.dir_path) < needed:
            log.warning(
                "compaction of %s backing off: need ~%d free bytes",
                self.dir_path,
                needed,
            )
            return

        # Merge runs off-loop so reads/writes stay responsive; it gets
        # cache-free sstable handles (the page cache is loop-owned).
        # Strategies exposing merge_async (the coalescer) coordinate on
        # the loop instead and offload their heavy stages themselves.
        inputs_nocache = [
            SSTable(self.dir_path, t.index, None) for t in inputs
        ]
        try:
            throttle = getattr(self.strategy, "throttle", None)
            if throttle is not None:
                # A fresh merge must not inherit debt accumulated since
                # the previous merge's last tick.
                throttle.reset()
            # gc_grace: when this merge DROPS tombstones, those newer
            # than (now - grace) survive anyway.  Stamped per merge so
            # the window tracks wall time, not tree lifetime.
            self.strategy.tombstone_drop_before = (
                now_nanos() - int(self.gc_grace_s * 1e9)
                if not keep_tombstones and self.gc_grace_s > 0
                else None
            )
            # Index DDL rides the strategy the same way: every built-in
            # merge emits a compact_fidx run from its still-resident
            # output buffers when this is set (the pipeline of merges
            # of 64 MiB or more emits none, as in dbeel_tpu).
            self.strategy.index_fields = self.index_fields
            merge_async = getattr(self.strategy, "merge_async", None)
            if merge_async is not None:
                result = await merge_async(
                    inputs_nocache,
                    self.dir_path,
                    output_index,
                    None,
                    keep_tombstones,
                    self.bloom_min_size,
                )
            else:
                result = await asyncio.get_event_loop().run_in_executor(
                    None,
                    self.strategy.merge,
                    inputs_nocache,
                    self.dir_path,
                    output_index,
                    None,
                    keep_tombstones,
                    self.bloom_min_size,
                )
        except CorruptedFile as e:
            # The merge read a corrupt input block (compaction rewrites
            # every byte of the store, so it is also a scrubber):
            # quarantine the offending input so the next cycle never
            # re-feeds it, then surface to the compaction loop's
            # error handling.
            self.quarantine_by_exception(e, inputs)
            raise
        finally:
            for t in inputs_nocache:
                t.close()

        # Journal {renames, deletes}, fsync, then apply (1090-1111).
        renames = [
            [
                os.path.join(
                    self.dir_path,
                    file_name(output_index, COMPACT_DATA_FILE_EXT),
                ),
                os.path.join(
                    self.dir_path, file_name(output_index, DATA_FILE_EXT)
                ),
            ],
            [
                os.path.join(
                    self.dir_path,
                    file_name(output_index, COMPACT_INDEX_FILE_EXT),
                ),
                os.path.join(
                    self.dir_path, file_name(output_index, INDEX_FILE_EXT)
                ),
            ],
        ]
        if result.wrote_bloom:
            renames.append(
                [
                    os.path.join(
                        self.dir_path,
                        file_name(output_index, COMPACT_BLOOM_FILE_EXT),
                    ),
                    os.path.join(
                        self.dir_path,
                        file_name(output_index, BLOOM_FILE_EXT),
                    ),
                ]
            )
        # Checksum sidecar rides the same journaled rename.  Every
        # merge strategy writes compact_sums INLINE (CRCs accumulated
        # while the output bytes were still in RAM / in the writer);
        # this post-hoc re-read is the safety net for a refused CRC
        # handoff, and it is COUNTED in the read amplification.
        from .compaction import compaction_stats

        compact_sums = os.path.join(
            self.dir_path,
            file_name(output_index, COMPACT_SUMS_FILE_EXT),
        )
        if not os.path.exists(compact_sums):
            await asyncio.get_event_loop().run_in_executor(
                None,
                checksums.compute_and_write,
                self.dir_path,
                output_index,
                renames[0][0],
                renames[1][0],
                os.path.join(
                    self.dir_path,
                    file_name(output_index, COMPACT_BLOOM_FILE_EXT),
                ),
                COMPACT_SUMS_FILE_EXT,
            )
            reread = 0
            for p in (
                renames[0][0],
                renames[1][0],
                os.path.join(
                    self.dir_path,
                    file_name(output_index, COMPACT_BLOOM_FILE_EXT),
                ),
            ):
                try:
                    reread += os.path.getsize(p)
                except OSError:
                    pass
            compaction_stats.note_sidecar(False, reread)
        else:
            compaction_stats.note_sidecar(True)
        # One completed merge pass: inputs (data + index) are read
        # exactly once; outputs = the renamed triplet + sidecar.
        input_bytes = sum(
            t.data_size + t.entry_count * 16 for t in inputs
        )
        written_bytes = 0
        for src, _dst in renames:
            try:
                written_bytes += os.path.getsize(src)
            except OSError:
                pass
        try:
            written_bytes += os.path.getsize(compact_sums)
        except OSError:
            pass
        compaction_stats.note_merge(input_bytes, written_bytes)
        renames.append(
            [
                compact_sums,
                os.path.join(
                    self.dir_path,
                    file_name(output_index, SUMS_FILE_EXT),
                ),
            ]
        )
        # Secondary-index run: when the merge emitted one, it rides the
        # SAME action journal — data and index runs rename (and below,
        # retire) in lockstep, so a crash replay can never leave one
        # without the other.
        compact_fidx = os.path.join(
            self.dir_path,
            file_name(output_index, COMPACT_FIDX_FILE_EXT),
        )
        if os.path.exists(compact_fidx):
            try:
                compaction_stats.note_index(
                    os.path.getsize(compact_fidx)
                )
            except OSError:
                pass
            renames.append(
                [
                    compact_fidx,
                    os.path.join(
                        self.dir_path,
                        file_name(output_index, FIDX_FILE_EXT),
                    ),
                ]
            )
            renames.append(
                [
                    os.path.join(
                        self.dir_path,
                        file_name(
                            output_index, COMPACT_FIDX_SUMS_FILE_EXT
                        ),
                    ),
                    os.path.join(
                        self.dir_path,
                        file_name(output_index, FIDX_SUMS_FILE_EXT),
                    ),
                ]
            )
        deletes = [p for t in inputs for p in t.paths()]
        action_path = os.path.join(
            self.dir_path, file_name(output_index, COMPACT_ACTION_FILE_EXT)
        )

        def _write_journal():
            # The journal's fsync blocks: write it off-loop.  It must
            # be durable BEFORE the renames mutate live files, so the
            # executor call is awaited here.
            with open(action_path, "wb") as f:
                f.write(
                    journal.packb({"renames": renames, "deletes": deletes})
                )
                f.flush()
                os.fsync(f.fileno())

        await asyncio.get_event_loop().run_in_executor(
            None, _write_journal
        )

        for src, dst in renames:
            # Audited sync I/O: rename is metadata-only (µs-scale)
            # and must stay ordered between the journal fsync above
            # and the table-list swap below — an executor hop would
            # open a window where a crash-recovery scan sees neither
            # the journal'd nor the renamed state applied.
            os.replace(src, dst)  # lint: allow(async-blocking)

        old_list = self._sstables
        survivors = [
            t for t in self._sstables.tables if t.index not in index_set
        ]
        output_table = SSTable(
            self.dir_path, output_index, self.cache,
            counters=self.durability,
        )
        asyncio.get_event_loop().run_in_executor(
            None, output_table.warm
        ).add_done_callback(lambda _f: self._notify_write_state())
        survivors.append(output_table)
        # SSTableList sorts by index: the even/odd scheme ranks the
        # output (max(inputs)+1) below any table flushed DURING this
        # compaction, so reversed() keeps probing newest data first.
        self._sstables = SSTableList(survivors)
        # A cached scan stage holds a reader ref on the old list: drop
        # it now, or the drain below would wait for the next scan.  The
        # native data plane must swap to the new table list before the
        # inputs are closed and unlinked below (its dup'd fds keep the
        # old tables safe mid-probe).
        self._notify_write_state()

        # Reader drain before deleting inputs (1141-1145).
        while old_list.readers > 0:
            await old_list.drained.listen()
        for t in inputs:
            t.close()
            if self.cache is not None:
                self.cache.invalidate_file((DATA_FILE_EXT, t.index))
                self.cache.invalidate_file((INDEX_FILE_EXT, t.index))

        def _dispose_inputs():
            # Unlinking hundreds of MB of input tables blocks for
            # tens of ms — run it off-loop.  The action journal goes LAST, preserving the
            # replay contract: a crash mid-disposal re-runs the
            # journal's idempotent deletes on open.
            for victim in deletes:
                if os.path.exists(victim):
                    os.unlink(victim)
            os.unlink(action_path)

        await asyncio.get_event_loop().run_in_executor(
            None, _dispose_inputs
        )
        self.flow.notify(flow_events.FlowEvent.COMPACTION_DONE)

    # ------------------------------------------------------------------
    # Iteration (lsm_tree.rs:141-282) — sstables oldest→newest, then the
    # memtables; duplicates possible, consumers resolve by timestamp.
    # ------------------------------------------------------------------

    async def iter_filter(
        self,
        filter_fn: Optional[Callable[[bytes, bytes, int], bool]] = None,
    ) -> AsyncIterator[Tuple[bytes, bytes, int]]:
        # Snapshot the memtables NOW, before any await, exactly like the
        # reference snapshots them at AsyncIter construction (lsm_tree.rs
        # :155-172) — a flush completing mid-iteration must not make
        # entries vanish from the view.
        memtable_items: List[Tuple[bytes, bytes, int]] = []
        if self._flushing is not None:
            memtable_items.extend(
                (k, v, ts)
                for k, (v, ts) in self._flushing.sorted_items()
            )
        memtable_items.extend(
            (k, v, ts) for k, (v, ts) in self._active.sorted_items()
        )
        snapshot = self._sstables
        snapshot.acquire()
        try:
            for table in snapshot.tables:
                count = 0
                try:
                    for key, value, ts in table.entries():
                        if filter_fn is None or filter_fn(
                            key, value, ts
                        ):
                            yield key, value, ts
                        count += 1
                        if count % 256 == 0:
                            await asyncio.sleep(0)
                except CorruptedFile as e:
                    # Scan-path corruption: quarantine the source
                    # table (repair owns the heal) and re-raise — a
                    # partial scan must not masquerade as a complete
                    # one (AE digests would claim authority over
                    # entries the scan never saw).
                    self.quarantine_by_exception(
                        e, snapshot.tables
                    )
                    raise
            for key, value, ts in memtable_items:
                if filter_fn is None or filter_fn(key, value, ts):
                    yield key, value, ts
        finally:
            snapshot.release()

    def iter(self) -> AsyncIterator[Tuple[bytes, bytes, int]]:
        return self.iter_filter(None)

    # ------------------------------------------------------------------
    # Streaming scan pages: batched columnar iteration through a
    # cached ScanStage — the vectorized range-digest staging
    # generalized to ordered, value-bearing pages.  Chunks of one
    # cursor walk hit the same stage; any write or table-list change
    # invalidates it.
    # ------------------------------------------------------------------

    def _scan_stage_token(self) -> tuple:
        return (
            tuple(t.index for t in self._sstables.tables),
            id(self._active),
            self._appends_since_swap,
            len(self._active),
            self._flushing is not None,
        )

    def _notify_write_state(self) -> None:
        """A write-state change: drop the cached scan stage, then tell
        the listener (the data plane); a failing listener is logged,
        never raised into the flush or compaction that notified."""
        self._drop_scan_stage()
        if self.write_state_listener is not None:
            try:
                self.write_state_listener(self)
            except Exception:
                log.exception("write_state_listener failed")

    def _drop_scan_stage(self) -> None:
        """Every write-state change (flush swap, table-list swap,
        quarantine, close) drops the cached stage HERE — not lazily on
        the next scan — because compaction and quarantine retirement
        wait for the old list's readers to drain, and a cached stage's
        reader ref with no scan running would stall them."""
        if self._scan_stage is not None:
            self._scan_stage = None
            self._scan_stage_key = None
            self._scan_stage_list.release()
            self._scan_stage_list = None
        # Index runs are per-table immutable artifacts, but the cache
        # is keyed by table index: drop them with the stage so stale
        # runs never outlive the tables they describe.
        if self._index_runs:
            self._index_runs = {}

    async def _current_scan_stage(self):
        """The cached vectorized stage for the CURRENT tree state, or
        None (guard tripped — caller uses the per-entry path).  Holds
        one reader ref on the staged sstable list so compaction
        cannot retire the files under later pages of the same
        stage."""
        from . import scan_stage as ss

        token = self._scan_stage_token()
        if (
            self._scan_stage is not None
            and self._scan_stage_key == token
        ):
            return self._scan_stage
        self._drop_scan_stage()
        total = self.memtable_entries + self.sstable_entry_count()
        if total < ss.MIN_VECTORIZED_ENTRIES:
            return None
        snap = self.scan_snapshot()
        try:
            stage = await asyncio.get_event_loop().run_in_executor(
                None,
                ss.build_stage,
                snap.memtable_items,
                snap.tables,
                self.device,
            )
        except CorruptedFile as e:
            self.quarantine_by_exception(e, snap.tables)
            snap.release()
            raise
        except BaseException:
            snap.release()
            raise
        if stage is None:
            snap.release()
            return None
        if self._scan_stage_token() != token:
            # A write or swap landed during the executor build: the
            # stage is already stale — serve this one page from it
            # (it is a valid point-in-time view) but don't cache it.
            # The snapshot ref is released by scan_page's finally.
            stage._hold = snap
            return stage
        if (
            self._scan_stage is not None
            and self._scan_stage_key == token
        ):
            # A concurrent cold-cache build won the race and already
            # cached an identical stage: use it and release OUR
            # snapshot ref — overwriting the cache here would orphan
            # the winner's reader ref and stall compaction's reader
            # drain forever.
            snap.release()
            return self._scan_stage
        self._drop_scan_stage()  # release any stale cached ref
        self._scan_stage = stage
        self._scan_stage_key = token
        self._scan_stage_list = snap._sstables  # cache owns the ref
        snap._released = True  # ownership moved to the cache
        return stage

    async def scan_page(
        self,
        start: int,
        end: int,
        start_after,
        prefix,
        limit: int,
        max_bytes: int,
        with_values: bool,
    ) -> Tuple[list, bool]:
        """One ordered scan page: up to ``limit`` entries /
        ``max_bytes`` emitted bytes of [key, value|nil, ts] with
        hash(key) in the wrap range [start, end), key > start_after
        (and starting with ``prefix`` when given), ascending by key;
        newest entry per key, tombstones included as value=b"".
        Returns (entries, more).  Vectorized through the cached
        ScanStage; per-entry fallback otherwise."""
        stage = await self._current_scan_stage()
        if stage is not None:
            # Pin the staged table files across the materialization's
            # cooperative yields: a flush/compaction swap during an
            # await drops the CACHE's ref, and without this per-call
            # ref the input files could be retired mid-read.
            hold_list = None
            if stage._hold is None and stage is self._scan_stage:
                hold_list = self._scan_stage_list
                if hold_list is not None:
                    hold_list.acquire()
            try:
                # Selection is pure numpy over the remaining
                # keyspace.  Only genuinely large stages go off-loop
                # (mask/cumsum there would stall point ops for ms);
                # below the threshold the executor hand-off latency
                # (~ms of idle epoll per hop, measured) costs more
                # than the selection itself.
                if stage.n >= 200_000:
                    pos, more = await asyncio.get_event_loop(
                    ).run_in_executor(
                        None,
                        stage.select,
                        start, end, start_after, prefix, limit,
                        max_bytes, with_values,
                    )
                else:
                    pos, more = stage.select(
                        start, end, start_after, prefix, limit,
                        max_bytes, with_values,
                    )
                entries: list = []
                for j in range(0, len(pos), 512):
                    entries.extend(
                        stage.entries_at(
                            pos[j : j + 512], with_values
                        )
                    )
                    # Yield between slices of value reads so point
                    # ops interleave within a large page.
                    await asyncio.sleep(0)
                return entries, more
            except CorruptedFile as e:
                # Stage-read corruption (value-page CRC): quarantine
                # the attributed table so repair starts NOW, then
                # error the page retryably — the coordinator's
                # stream dies and the client resumes elsewhere.
                self.quarantine_by_exception(
                    e,
                    [
                        s.table
                        for s in stage.sources
                        if not isinstance(s, list)
                    ],
                )
                raise
            finally:
                if hold_list is not None:
                    hold_list.release()
                if stage._hold is not None:
                    stage._hold.release()
                    stage._hold = None
        return await self._scan_page_fallback(
            start, end, start_after, prefix, limit, max_bytes,
            with_values,
        )

    def _quarantine_index_run(self, tidx: int) -> None:
        """Contain a corrupt secondary-index run WITHOUT touching its
        data table: the run is a derived artifact, so it moves to
        quarantine/ alone (the triplet keeps serving) and the caller
        surfaces a retryable CorruptedFile — the client's retry
        replans without the run."""
        from . import secondary_index as si

        if tidx in self._fidx_quarantined:
            return
        self._fidx_quarantined.add(tidx)
        self._index_runs[tidx] = None
        self.durability["checksum_failures"] += 1
        si.index_stats.note_quarantine()
        fidx_p, fsums_p = si.run_paths(self.dir_path, tidx)
        qdir = os.path.join(self.dir_path, QUARANTINE_DIR)
        log.error(
            "quarantining corrupt index run %s (data table stays "
            "live)",
            fidx_p,
        )

        def _move():
            os.makedirs(qdir, exist_ok=True)
            for p in (fidx_p, fsums_p):
                try:
                    if os.path.exists(p):
                        os.replace(
                            p,
                            os.path.join(qdir, os.path.basename(p)),
                        )
                except OSError:
                    log.warning(
                        "index-run quarantine move failed for %s", p
                    )

        # The loader reads the whole file and closes it, so nothing
        # holds the run open — the move needs no reader drain.
        asyncio.get_event_loop().run_in_executor(None, _move)

    async def _load_index_runs(self, stage) -> dict:
        """stage source position -> IndexRun for every staged table
        with a usable run, loading uncached runs off-loop.  A
        provably-corrupt run quarantines (alone) and raises a
        retryable CorruptedFile tagged ``index_run_only``."""
        from . import secondary_index as si

        runs_by_src: dict = {}
        loop = asyncio.get_event_loop()
        for s, source in enumerate(stage.sources):
            if isinstance(source, list):
                continue
            tidx = source.table.index
            if tidx in self._fidx_quarantined:
                continue
            if tidx not in self._index_runs:
                try:
                    run = await loop.run_in_executor(
                        None, si.load_run, self.dir_path, tidx
                    )
                except CorruptedFile as e:
                    self._quarantine_index_run(tidx)
                    e.index_run_only = True
                    raise
                self._index_runs[tidx] = run
            run = self._index_runs[tidx]
            if run is not None:
                runs_by_src[s] = run
        return runs_by_src

    async def _scan_filter_indexed(
        self,
        stage,
        start: int,
        end: int,
        start_after,
        prefix,
        limit: int,
        max_bytes: int,
        where,
        agg,
    ):
        """Index-planned page: ``(pos, more, sbytes, matched,
        partial)`` or None (planner miss — the caller runs the
        vectorized evaluator).  The window cut is the exact
        ``select_window`` the non-indexed path uses; only the
        EVALUATION shrinks, to a golden ``match_entry`` re-check of
        the index's candidate rows — so results, covers and
        accounting cannot diverge."""
        from .. import query as Q
        from . import query_vec
        from . import secondary_index as si
        from .entry import ENTRY_HEADER_SIZE

        runs_by_src = await self._load_index_runs(stage)

        def _plan_and_select():
            cand = si.candidate_mask(
                stage, where, runs_by_src, self.index_fields
            )
            if cand is None:
                return None
            pos, more, sbytes = stage.select_window(
                start, end, start_after, prefix, limit, max_bytes
            )
            flags = np.zeros(pos.size, dtype=bool)
            csub = np.flatnonzero(cand[pos])
            vlen = stage.vlen
            for i in csub.tolist():
                p = int(pos[i])
                if vlen[p] == 0:
                    continue  # tombstone: matches nothing
                source = stage.sources[int(stage.src[p])]
                if isinstance(source, list):
                    value = source[int(stage.off[p])][1]
                else:
                    value = source.value_at(
                        int(stage.off[p])
                        + ENTRY_HEADER_SIZE
                        + int(stage.klen[p]),
                        int(vlen[p]),
                    )
                if Q.match_entry(where, stage.key_at(p), value):
                    flags[i] = True
            matched = pos[flags]
            partial = (
                query_vec.agg_partial_for(stage, matched, agg)
                if agg is not None
                else None
            )
            return pos, more, sbytes, matched, partial

        # Candidate-mask searchsorteds + per-candidate value reads:
        # off-loop (a selective predicate touches few values, but the
        # membership probe is O(stage rows) per leaf).
        return await asyncio.get_event_loop().run_in_executor(
            None, _plan_and_select
        )

    async def scan_filter_page(
        self,
        start: int,
        end: int,
        start_after,
        prefix,
        limit: int,
        max_bytes: int,
        with_values: bool,
        where,
        agg,
        mode: str,
    ) -> tuple:
        """One filtered/aggregated scan page (query compute plane):
        ``(entries, more, cover, scanned_rows,
        scanned_bytes, agg_partial, eval_path)``.

        The window advances by bytes SCANNED (key+value+overhead of
        every arc-member row examined), so a selective predicate
        still pages in bounded work and the ``cover`` key lets the
        coordinator resume past a window that matched nothing.
        ``mode`` is the peer-spec contract (query.MODE_DROP /
        MODE_MARK — see query.py): drop emits matching rows only
        (or, with ``agg``, just a partial state); mark emits EVERY
        newest-per-key row as [key, payload, ts, flag] so the
        coordinator's newest-wins dedup decides acceptance.
        ``eval_path`` says which evaluator ran ("indexed" / "device" /
        "numpy" / "cached" / "golden") for the stats plane: "indexed"
        when the secondary-index runs planned the page, "device" when a
        numeric leaf ran a filter kernel on the tree's ``device`` (the
        card, or with ``"cpu"`` the kernel's plain version)."""
        from .. import query as Q
        from . import query_vec

        stage = await self._current_scan_stage()
        if stage is None:
            return await self._scan_filter_page_fallback(
                start, end, start_after, prefix, limit, max_bytes,
                with_values, where, agg, mode,
            )
        hold_list = None
        if stage._hold is None and stage is self._scan_stage:
            hold_list = self._scan_stage_list
            if hold_list is not None:
                hold_list.acquire()
        try:
            # Secondary-index plan: when this collection
            # declares indexed fields and the spec is plannable
            # (predicate present, drop mode, no agg or count — other
            # aggs need the full field column anyway), consult the
            # per-table index runs to shrink the exact evaluation to
            # the candidate rows inside the SAME select_window cut.
            # Windows, covers and scanned-byte accounting are shared
            # with the non-indexed path, so results stay
            # byte-identical; a planner miss falls through to the
            # vectorized evaluator below.
            if (
                self.index_fields
                and where is not None
                and mode == Q.MODE_DROP
                and (agg is None or agg.get("op") == "count")
            ):
                got = await self._scan_filter_indexed(
                    stage, start, end, start_after, prefix, limit,
                    max_bytes, where, agg,
                )
                if got is not None:
                    pos, more, sbytes, matched, partial = got
                    cover = (
                        stage.key_at(int(pos[-1]))
                        if pos.size
                        else None
                    )
                    entries = []
                    if agg is None:
                        for j in range(0, len(matched), 512):
                            entries.extend(
                                stage.entries_at(
                                    matched[j : j + 512],
                                    with_values,
                                )
                            )
                            await asyncio.sleep(0)
                    return (
                        entries,
                        more,
                        cover,
                        int(pos.size),
                        int(sbytes),
                        partial,
                        "indexed",
                    )
            need_build = bool(
                Q.spec_fields(where, agg)
                - set(stage._field_cols)
            ) or (
                # A mask-cache miss re-evaluates the whole tree —
                # including any O(n) scalar-leaf loops (trailing-NUL
                # operands, >2^53 ints) — so it goes off-loop even
                # when every column already exists.
                where is not None
                and msgpack_codec.packb(where) not in stage._mask_cache
            )

            def _select():
                pos, more, sbytes = stage.select_window(
                    start, end, start_after, prefix, limit,
                    max_bytes,
                )
                mask, path = query_vec.eval_where(stage, where)
                sub = mask[pos]
                matched = pos[sub]
                partial = None
                if agg is not None and mode == Q.MODE_DROP:
                    partial = query_vec.agg_partial_for(
                        stage, matched, agg
                    )
                return pos, more, sbytes, sub, matched, partial, path

            # The first evaluation of a spec decodes the targeted
            # field for EVERY staged row (the batched column build):
            # always off-loop.  Re-evaluations are cached-mask
            # lookups plus a window searchsorted — loop-side below
            # the same size bar scan_page uses.  Off-loop, the K8
            # launches run on the executor thread's current stream and
            # copy their masks back on it before numpy reads them.
            if need_build or stage.n >= 200_000:
                (
                    pos, more, sbytes, sub, matched, partial, path,
                ) = await asyncio.get_event_loop().run_in_executor(
                    None, _select
                )
            else:
                (
                    pos, more, sbytes, sub, matched, partial, path,
                ) = _select()
            cover = (
                stage.key_at(int(pos[-1])) if pos.size else None
            )
            if mode == Q.MODE_DROP:
                entries: list = []
                if agg is None:
                    for j in range(0, len(matched), 512):
                        entries.extend(
                            stage.entries_at(
                                matched[j : j + 512], with_values
                            )
                        )
                        await asyncio.sleep(0)
            else:  # mark: every newest-per-key row, flagged
                keys = stage.keys[pos].tolist()
                ts = stage.ts[pos].tolist()
                vl = stage.vlen[pos].tolist()
                flags = sub.tolist()
                fcol = (
                    query_vec.field_column(stage, agg["field"])
                    if agg is not None and agg.get("field")
                    else None
                )
                entries = []
                for i, p in enumerate(pos.tolist()):
                    if vl[i] == 0:
                        entries.append([keys[i], b"", ts[i], 0])
                        continue
                    if not flags[i]:
                        entries.append([keys[i], None, ts[i], 0])
                        continue
                    if agg is not None:
                        payload = (
                            fcol.typed_at(p)
                            if fcol is not None
                            else None
                        )
                        if isinstance(payload, bytes):
                            payload = None  # non-numeric: never folds
                    elif with_values:
                        payload = query_vec._value_bytes(stage, p)
                    else:
                        payload = None
                    entries.append([keys[i], payload, ts[i], 1])
                    if i and i % 512 == 0:
                        await asyncio.sleep(0)
            return (
                entries,
                more,
                cover,
                int(pos.size),
                int(sbytes),
                partial,
                path,
            )
        except CorruptedFile as e:
            # Column build / value materialization hit a flipped
            # page: quarantine the attributed table so repair starts
            # NOW, then error retryably (the coordinator stream dies
            # and the client resumes elsewhere) — same contract as
            # the unfiltered staged path.  A corrupt INDEX RUN is
            # contained separately (_quarantine_index_run): the data
            # triplet is untouched, so it must NOT be quarantined
            # off the run's path attribution.
            if not getattr(e, "index_run_only", False):
                self.quarantine_by_exception(
                    e,
                    [
                        s.table
                        for s in stage.sources
                        if not isinstance(s, list)
                    ],
                )
            raise
        finally:
            if hold_list is not None:
                hold_list.release()
            if stage._hold is not None:
                stage._hold.release()
                stage._hold = None

    async def _scan_filter_page_fallback(
        self,
        start: int,
        end: int,
        start_after,
        prefix,
        limit: int,
        max_bytes: int,
        with_values: bool,
        where,
        agg,
        mode: str,
    ) -> tuple:
        """Golden per-entry filtered page (tiny trees / guard trips):
        the reference evaluator the vectorized path is byte-identical
        to, with the same scanned-window accounting."""
        from ..utils.murmur import hash_bytes as _hash_bytes
        from .. import query as Q
        from . import scan_stage as ss

        newest: dict = {}
        async for key, value, ts in self.iter_filter(None):
            if start_after is not None and key <= start_after:
                continue
            if prefix and not key.startswith(prefix):
                continue
            h = _hash_bytes(key)
            width = (end - start) & 0xFFFFFFFF
            if width != 0 and ((h - start) & 0xFFFFFFFF) >= width:
                continue
            prev = newest.get(key)
            if prev is None or ts > prev[1]:
                newest[key] = (value, ts)
        items = sorted(newest.items())
        entries: list = []
        partial_state = None
        agg_rows: list = []
        scanned = 0
        used = 0
        more = False
        cover = None
        for i, (key, (value, ts)) in enumerate(items):
            # Window cut mirrors ScanStage.select_window exactly
            # (the byte-identical contract includes covers and
            # scanned accounting): rows accumulate until the first
            # one that REACHES the budget, inclusive.
            cost = len(key) + ss.ENTRY_OVERHEAD + len(value)
            used += cost
            scanned += 1
            cover = key
            stop = scanned >= limit or used >= max_bytes
            matched = Q.match_entry(where, key, value)
            if mode == Q.MODE_DROP:
                if matched:
                    if agg is not None:
                        agg_rows.append((key, value))
                    elif with_values:
                        entries.append([key, value, ts])
                    else:
                        entries.append([key, None, ts])
            else:  # mark
                if len(value) == 0:
                    entries.append([key, b"", ts, 0])
                elif not matched:
                    entries.append([key, None, ts, 0])
                elif agg is not None:
                    x = Q.field_value(
                        Q.decode_doc(value), agg["field"]
                    ) if agg.get("field") else None
                    if isinstance(x, (str, bytes)):
                        x = None
                    entries.append([key, x, ts, 1])
                elif with_values:
                    entries.append([key, value, ts, 1])
                else:
                    entries.append([key, None, ts, 1])
            if stop:
                more = i + 1 < len(items)
                break
        if agg is not None and mode == Q.MODE_DROP:
            group = agg["group"]
            if group:
                groups: dict = {}
                for key, value in agg_rows:
                    x = (
                        Q.field_value(
                            Q.decode_doc(value), agg["field"]
                        )
                        if agg.get("field")
                        else None
                    )
                    if not Q.contributes(agg["op"], x):
                        continue
                    g = key[:group]
                    st = groups.get(g)
                    if st is None:
                        st = groups[g] = Q.agg_new()
                    Q.agg_fold(
                        st,
                        agg["op"],
                        None if agg["op"] == "count" else x,
                    )
                partial_state = [
                    [g, st] for g, st in sorted(groups.items())
                ]
            else:
                partial_state = Q.agg_new()
                for key, value in agg_rows:
                    x = (
                        Q.field_value(
                            Q.decode_doc(value), agg["field"]
                        )
                        if agg.get("field")
                        else None
                    )
                    if not Q.contributes(agg["op"], x):
                        continue
                    Q.agg_fold(
                        partial_state,
                        agg["op"],
                        None if agg["op"] == "count" else x,
                    )
        return (
            entries, more, cover, scanned, used, partial_state,
            "golden",
        )

    async def _scan_page_fallback(
        self,
        start: int,
        end: int,
        start_after,
        prefix,
        limit: int,
        max_bytes: int,
        with_values: bool,
    ) -> Tuple[list, bool]:
        """Per-entry page (tiny trees / no native lib / guard trips):
        one full newest-wins walk, then the page cut.  Byte-identical
        ordering and dedup to the staged path."""
        from ..utils.murmur import hash_bytes as _hash_bytes
        from . import scan_stage as ss

        newest: dict = {}
        async for key, value, ts in self.iter_filter(None):
            if start_after is not None and key <= start_after:
                continue
            if prefix and not key.startswith(prefix):
                continue
            h = _hash_bytes(key)
            width = (end - start) & 0xFFFFFFFF
            if width != 0 and ((h - start) & 0xFFFFFFFF) >= width:
                continue
            prev = newest.get(key)
            if prev is None or ts > prev[1]:
                newest[key] = (value, ts)
        entries: list = []
        used = 0
        items = sorted(newest.items())
        for i, (key, (value, ts)) in enumerate(items):
            vlen = len(value)
            cost = len(key) + ss.ENTRY_OVERHEAD + (
                vlen if with_values else 0
            )
            if entries and (
                used + cost > max_bytes or len(entries) >= limit
            ):
                return entries, True
            used += cost
            if vlen == 0:
                entries.append([key, b"", ts])
            elif with_values:
                entries.append([key, value, ts])
            else:
                entries.append([key, None, ts])
            if len(entries) >= limit and i + 1 < len(items):
                return entries, True
        return entries, False

    def scan_snapshot(self) -> "ScanSnapshot":
        """Synchronous point-in-time view for OFF-LOOP bulk scans
        (vectorized anti-entropy digests): memtable items materialized
        now, sstable list acquired so compaction cannot delete the
        files under the scan.  Caller MUST release()."""
        items: List[Tuple[bytes, bytes, int]] = []
        if self._flushing is not None:
            items.extend(
                (k, v, ts)
                for k, (v, ts) in self._flushing.sorted_items()
            )
        items.extend(
            (k, v, ts) for k, (v, ts) in self._active.sorted_items()
        )
        snapshot = self._sstables
        snapshot.acquire()
        return ScanSnapshot(items, snapshot)

    # ------------------------------------------------------------------

    def _table_index_from_path(self, path) -> Optional[int]:
        """Sstable index encoded in a triplet file path (CorruptedFile
        attribution from merge workers), or None."""
        if not path:
            return None
        m = _FILE_RE.match(os.path.basename(path))
        return int(m.group(1)) if m else None

    async def purge(self) -> None:
        """Delete the tree from disk (drop collection, shards.rs:369-381).

        Every table's cached pages are invalidated BEFORE the files
        go: page-cache keys are (collection-name-hash, (ext, index),
        address), all of which a re-created same-name collection
        recycles from 0 — without the invalidation its reads would
        serve the DROPPED collection's pages."""
        self.close()
        if self.cache is not None:
            for t in self._sstables.tables:
                self.cache.invalidate_file((DATA_FILE_EXT, t.index))
                self.cache.invalidate_file((INDEX_FILE_EXT, t.index))
        # Audited sync I/O: purge runs on the operator-rate DROP path
        # after close() — nothing else serves this tree anymore.
        shutil.rmtree(self.dir_path, ignore_errors=True)  # lint: allow(async-blocking)
