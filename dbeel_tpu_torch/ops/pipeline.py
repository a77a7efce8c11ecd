"""Partitioned, fully-overlapped device compaction pipeline.

A major compaction is a keyspace-partitioned software pipeline in which
every stage runs concurrently on its own partition:

  upload thread    O_DIRECT bulk reads (native C++), 8-byte-prefix
                   staging into pinned host memory, per-batch
                   host→device copy + kernel launch on a side CUDA stream
  download thread  waits on the CUDA event recorded after each launch,
                   then copies the packed run ids device→host into
                   pinned memory
  caller thread    permutation rebuild → vectorized tie fixup → dedup →
                   tombstone filter → native C++ gather + O_DIRECT
                   streaming write

Transfer volume is kept small:

  * Uplink: each partition's 8-byte prefixes are rebased to the
    partition minimum and right-shifted until the span fits 32 bits —
    an order-preserving u32 approximation, ONE word per entry (K1).
    Collisions under the shift become tie blocks fixed up on the host
    exactly like genuinely equal prefixes; partitions where the shift
    would collapse dense clusters (cheap host check) keep the exact
    2-word operand (K2).
  * Downlink: within a partition each run's survivors appear in
    increasing position order, so the kernel returns only the
    bit-packed run-id sequence (~4 bits/entry) and the host rebuilds
    positions with per-run counters.

Tie blocks (equal u32 approximations, shared 8-byte prefixes, long
keys) are re-ordered by one vectorized lexsort over padded key words —
(full key asc, newest ts, newest src), the reference merge order
(reference src/storage_engine/lsm_tree.rs:1038-1066).  Partitions are
keyspace ranges cut at sampled 8-byte key prefixes, so equal prefixes
(hence equal keys, hence every dedup decision) never cross a partition
boundary.  Output bytes are identical to every other strategy (golden
tests enforce it).

On ``device="cpu"`` the same threads run the kernels' plain PyTorch
versions synchronously (the CPU tests).

With a ``mesh`` of several partitions (``parallel.mesh``) the launch
batch widens to a multiple of the partition count and its J axis is
split over the partitions: slot slice s is uploaded to, and merged on,
``mesh.devices[s]``.  Keyspace partitions are disjoint sorted ranges,
so this is pure data parallelism with no exchange between devices;
the output bytes are those of the pipeline without a mesh.
"""

from __future__ import annotations

import ctypes
import logging
import os
import queue
import threading
import zlib
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..storage import columnar
from ..storage.compaction import MergeResult, _write_bloom
from ..storage.entry import (
    COMPACT_DATA_FILE_EXT,
    COMPACT_INDEX_FILE_EXT,
    ENTRY_HEADER_SIZE,
    file_name,
)

log = logging.getLogger(__name__)

SENTINEL = np.uint32(0xFFFFFFFF)
_ALIGN = 4096
# Per-(run, partition) kernel rows: pow2-padded; partitions are split
# until every slice fits.
_MAX_P2 = 1 << 17
# Per-partition row target used to pick the partition count.
_PAD_WASTE_LIMIT = 0.12
# A shifted-u32 partition whose within-run duplicate excess (collisions
# introduced by the shift, beyond genuine prefix ties) exceeds this
# fraction keeps the exact 2-word operand instead.
_SHIFT_DUP_LIMIT = 0.10
# Partitions per device launch: same-mode partitions are batched into
# one kernel launch (the batch axis J of K1/K2).
_LAUNCH_BATCH = 4
# Multi-batch partitioning (>=2 launch batches for stage overlap) only
# above this many total input rows — below it the extra per-launch
# dispatch outweighs the overlap.
_MULTIBATCH_MIN_ROWS = 1 << 19
# Background fdatasync stride: flush the output's device write cache
# every this many written bytes concurrently with the write stream.
# DISABLED by default (0): on some disks a concurrent fdatasync
# SERIALIZES against in-flight O_DIRECT pwrites and stalls the gather
# writer, while the single close-time flush is short.  Set
# DBEEL_SYNC_STRIDE to a byte count on devices whose close-time cache
# flush is the bigger tail.
try:
    _SYNC_STRIDE = int(os.environ.get("DBEEL_SYNC_STRIDE", 0))
except ValueError:
    logging.getLogger(__name__).warning(
        "DBEEL_SYNC_STRIDE=%r is not an integer byte count; "
        "background sync stays disabled",
        os.environ.get("DBEEL_SYNC_STRIDE"),
    )
    _SYNC_STRIDE = 0


def _unlink_quiet(*paths: str) -> None:
    import os

    for p in paths:
        try:
            os.unlink(p)
        except OSError:
            pass


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _aligned_empty(size: int) -> np.ndarray:
    """uint8 buffer whose base address and capacity are 4KiB-aligned
    (O_DIRECT contract of dbeel_read_file)."""
    cap = (size + _ALIGN - 1) & ~(_ALIGN - 1)
    raw = np.empty(cap + _ALIGN, dtype=np.uint8)
    off = (-raw.ctypes.data) % _ALIGN
    return raw[off : off + cap]


@dataclass
class _Run:
    data: np.ndarray  # uint8 (aligned), logical [:size]
    size: int
    offsets: np.ndarray  # u64 within-run record offsets
    key_size: np.ndarray  # u32
    full_size: np.ndarray  # u32
    prefix64: np.ndarray = field(default=None)  # (n,) >u8 padded prefix


def _read_run(lib, source) -> _Run:
    offs, ks, fs = source.read_index_columns()
    size = source.data_size
    buf = _aligned_empty(size)
    if size:
        got = lib.dbeel_read_file(
            source.data_path.encode(),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_uint64(size),
        )
        if got != size:
            raise OSError(
                f"short read {got} != {size} for {source.data_path}"
            )
    return _Run(buf, size, offs.astype(np.uint64), ks, fs)


def _stage_prefixes(run: _Run, lib=None) -> None:
    """Fill run.prefix64: the zero-padded 8-byte big-endian key prefix
    per entry as one >u8 value (splitters, searchsorted, and the
    per-partition rebase that feeds the device operand).  Prefers the
    C stager — the numpy paths hold the GIL for a whole run."""
    n = run.offsets.size
    if n == 0:
        run.prefix64 = np.zeros(0, dtype=">u8")
        return
    if lib is not None and hasattr(lib, "dbeel_stage_prefixes"):
        pref = np.empty(n * 8, dtype=np.uint8)
        offs = np.ascontiguousarray(run.offsets, dtype=np.uint64)
        ks = np.ascontiguousarray(run.key_size, dtype=np.uint32)
        lib.dbeel_stage_prefixes(
            run.data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_uint64(run.size),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ks.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.c_uint64(n),
            ctypes.c_uint64(ENTRY_HEADER_SIZE),
            pref.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        run.prefix64 = pref.view(">u8").reshape(n)
        return
    rec = int(run.full_size[0]) if run.full_size.size else 0
    uniform = (
        rec > 0
        and run.size == n * rec
        and (run.full_size == rec).all()
        and (
            run.offsets == np.arange(n, dtype=np.uint64) * np.uint64(rec)
        ).all()
        and (run.key_size >= 8).all()
    )
    if uniform:
        mat = run.data[: n * rec].reshape(n, rec)
        pref = np.ascontiguousarray(
            mat[:, ENTRY_HEADER_SIZE : ENTRY_HEADER_SIZE + 8]
        )
    else:
        lanes = np.arange(8, dtype=np.uint64)
        pos = (run.offsets + np.uint64(ENTRY_HEADER_SIZE))[:, None] + lanes
        valid = lanes < run.key_size.astype(np.uint64)[:, None]
        pos = np.minimum(pos, np.uint64(max(0, run.size - 1)))
        pref = np.where(
            valid, run.data[pos.astype(np.int64)], 0
        ).astype(np.uint8)
        pref = np.ascontiguousarray(pref)
    run.prefix64 = pref.view(">u8").reshape(n)


def _choose_partitions(runs: List[_Run], launch_batch: int = None):
    """Pick (splitters, per-run bounds, p2): keyspace cut points such
    that every run's slice fits the pow2 kernel rows ``p2`` with little
    padding.  ``launch_batch`` is the launch width (partitions per
    kernel launch).  Returns None if an equal-prefix group exceeds the
    kernel (the caller then falls back)."""
    if launch_batch is None:
        launch_batch = _LAUNCH_BATCH
    max_run = max((r.prefix64.size for r in runs), default=0)
    total_rows = sum(r.prefix64.size for r in runs)
    if max_run == 0:
        return np.zeros(0, dtype=">u8"), None, 8
    # Prefer enough partitions to fill at least TWO launch batches:
    # the pipeline's whole point is overlapping read/upload/kernel/
    # download/write, and with every partition in one batch the stages
    # run strictly serially (every writer put and consume lands after
    # the single kernel + download).  Within the two-to-four-batch band
    # take the smallest viable count (fewest launches); below it, fall
    # back to >=4 partitions, then any.
    viable = []
    for cand in range(1, 65):
        p2c = _pow2(-(-max_run // cand))
        if (
            p2c <= _MAX_P2
            and cand * p2c / max_run - 1.0 <= _PAD_WASTE_LIMIT
        ):
            viable.append(cand)
    # The multi-batch band only pays when there is real host work to
    # overlap: a tiny merge split into two launches just buys a second
    # launch.
    bands = (
        ((2 * launch_batch, 4 * launch_batch),)
        if total_rows >= _MULTIBATCH_MIN_ROWS
        else ()
    ) + ((4, 64), (1, 3))
    parts = None
    for lo, hi in bands:
        sel = [c for c in viable if lo <= c <= hi]
        if sel:
            parts = sel[0]
            break
    if parts is None:
        parts = -(-max_run // _MAX_P2)
    p2 = _pow2(-(-max_run // parts))

    samples = np.sort(
        np.concatenate(
            [
                r.prefix64[:: max(1, r.prefix64.size // 256)]
                for r in runs
                if r.prefix64.size
            ]
        )
    )
    cut = [
        samples[(k * samples.size) // parts]
        for k in range(1, parts)
    ]
    # strictly increasing splitters (duplicates collapse partitions)
    splitters = np.array(sorted(set(cut)), dtype=">u8")

    def bounds_for(splits):
        return [
            np.concatenate(
                [
                    np.zeros(1, np.int64),
                    np.searchsorted(
                        r.prefix64, splits, side="right"
                    ).astype(np.int64),
                    np.array([r.prefix64.size], np.int64),
                ]
            )
            for r in runs
        ]

    bounds = bounds_for(splitters)
    # Split any partition whose largest run-slice overflows p2.  The
    # split point is a median prefix inside the overflowing slice; if
    # no strictly-interior cut exists the range is one equal-prefix
    # group — unsplittable at this kernel size.
    for _ in range(64):
        overflow = None
        for r, b in zip(runs, bounds):
            cnt = np.diff(b)
            too_big = np.flatnonzero(cnt > p2)
            if too_big.size:
                overflow = (r, b, int(too_big[0]))
                break
        if overflow is None:
            break
        r, b, p = overflow
        lo, hi = int(b[p]), int(b[p + 1])
        uniq = np.unique(r.prefix64[lo:hi])
        if uniq.size < 2:
            return None  # one equal-prefix group > kernel rows
        # side="right" cuts put entries <= splitter left, so any value
        # strictly below the slice maximum splits it into two nonempty
        # halves.
        mid = uniq[(uniq.size - 1) // 2]
        splitters = np.array(
            sorted(set(splitters.tolist()) | {int(mid)}), dtype=">u8"
        )
        bounds = bounds_for(splitters)
    else:
        return None
    return splitters, bounds, p2


class _PipelineError(Exception):
    pass


# Process-wide pipeline accounting: runs that produced the output, and
# algorithmic declines (one equal-prefix group larger than the kernel
# rows: the merge then takes the single-shot path).
# Several shards' compaction loops merge at once from executor
# threads, so the counts are taken under a lock.
pipeline_stats = {"runs": 0, "declined": 0}
_stats_lock = threading.Lock()


# One profiler may run in a process at a time: traced merges take turns.
_trace_lock = threading.Lock()


def _traced(profile_dir: str, device: torch.device, run):
    """``run()`` under torch.profiler; its Chrome trace is written to
    ``profile_dir`` under a name unique to this merge (process id and a
    random suffix), and its result returned unchanged."""
    import uuid

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with _trace_lock:
        with profile(activities=activities) as prof:
            result = run()
        prof.export_chrome_trace(os.path.join(
            profile_dir,
            f"pipeline_merge-{os.getpid()}-{uuid.uuid4().hex}.json",
        ))
    return result


def pipeline_merge(
    sources: Sequence,
    dir_path: str,
    output_index: int,
    keep_tombstones: bool,
    bloom_min_size: int,
    device="cuda",
    throttle=None,
    tombstone_drop_before: "int | None" = None,
    mesh=None,
) -> Optional[MergeResult]:
    """Run the partitioned pipeline on ``device``.  Returns None only
    on the algorithmic decline (an equal-prefix group larger than the
    kernel rows, counted in ``pipeline_stats``) — the caller then takes
    the single-shot path.  A native library that cannot be built
    raises on a card; on ``cpu`` it declines too.

    ``mesh``: a ``parallel.mesh.Mesh`` — with more than one partition
    the launch batch's J axis is split over its devices (each merges
    its own keyspace partitions, no exchange between them).

    Set ``DBEEL_PROFILE_DIR`` to trace each merge with
    ``torch.profiler`` (host activity, and the card's when ``device``
    is one): one Chrome trace a merge is exported into that directory
    (viewable in chrome://tracing or Perfetto)."""
    device = torch.device(device)

    def run():
        return _pipeline_merge_impl(
            sources,
            dir_path,
            output_index,
            keep_tombstones,
            bloom_min_size,
            device,
            throttle,
            tombstone_drop_before,
            mesh=mesh,
        )

    profile_dir = os.environ.get("DBEEL_PROFILE_DIR")
    result = _traced(profile_dir, device, run) if profile_dir else run()
    with _stats_lock:
        pipeline_stats["runs" if result is not None else "declined"] += 1
    return result


def _partition_operand(runs, bounds, p, k2, p2):
    """Stage partition ``p``: choose the u32 (rebased+shifted) or exact
    2-word operand, build the sentinel-padded host array.

    Returns (host, counts, los, mode32, minpf, shift)."""
    counts = np.zeros(k2, dtype=np.uint32)
    los = np.zeros(len(runs), dtype=np.int64)
    slices = []
    minpf = None
    maxpf = None
    for ri, (r, b) in enumerate(zip(runs, bounds)):
        lo, hi = int(b[p]), int(b[p + 1])
        los[ri] = lo
        counts[ri] = hi - lo
        sl = r.prefix64[lo:hi]
        slices.append(sl)
        if hi > lo:
            first, last = int(sl[0]), int(sl[-1])
            minpf = first if minpf is None else min(minpf, first)
            maxpf = last if maxpf is None else max(maxpf, last)
    n_p = int(counts.sum())
    if n_p == 0:
        return None, counts, los, True, 0, 0
    span = maxpf - minpf
    shift = max(0, span.bit_length() - 32)
    mode32 = True
    shifted = [
        (sl.astype(np.uint64) - np.uint64(minpf)) >> np.uint64(shift)
        for sl in slices
    ]
    if shift:
        # Within-run duplicate excess introduced by the shift (beyond
        # genuine 8-byte-prefix ties): if the shift collapses dense
        # clusters, the host tie fixup would swallow the partition —
        # keep the exact operand there instead.
        d32 = 0
        d64 = 0
        for sl, v in zip(slices, shifted):
            if sl.size < 2:
                continue
            d32 += int((v[1:] == v[:-1]).sum())
            d64 += int((sl[1:] == sl[:-1]).sum())
        if d32 - d64 > _SHIFT_DUP_LIMIT * n_p:
            mode32 = False
    if mode32:
        host = np.full((k2, p2), SENTINEL, dtype=np.uint32)
        for ri, v in enumerate(shifted):
            if v.size:
                host[ri, : v.size] = v.astype(np.uint32)
    else:
        host = np.full((k2, p2, 2), SENTINEL, dtype=np.uint32)
        for ri, sl in enumerate(slices):
            if sl.size:
                v = sl.astype(np.uint64)
                host[ri, : sl.size, 0] = (v >> np.uint64(32)).astype(
                    np.uint32
                )
                host[ri, : sl.size, 1] = (
                    v & np.uint64(0xFFFFFFFF)
                ).astype(np.uint32)
    return host, counts, los, mode32, minpf, shift


def _gather_tie_arrays(runs, run_base, off_cat, ks_cat, sel, lpad):
    """Per-run vectorized gather of (padded key words, ~ts, ~src) for
    the tie-block entries ``sel`` (global indices), key matrix padded
    to ``lpad`` bytes (the caller buckets blocks by width)."""
    ri = (
        np.searchsorted(run_base, sel, side="right") - 1
    ).astype(np.int64)
    off = off_cat[sel]
    ks = ks_cat[sel]
    m = sel.size
    kwords = np.zeros((m, lpad // 8), dtype=np.uint64)
    ts = np.zeros(m, dtype=np.uint64)
    w8 = np.uint64(1) << (
        np.arange(8, dtype=np.uint64) * np.uint64(8)
    )
    for r in np.unique(ri):
        msk = ri == r
        data = runs[r].data
        o = off[msk]
        kwords[msk] = columnar.padded_key_words(
            data,
            o + np.uint64(ENTRY_HEADER_SIZE),
            ks[msk],
            pad_to=lpad,
        )
        tpos = (o + np.uint64(8))[:, None] + np.arange(
            8, dtype=np.uint64
        )
        ts[msk] = (
            data[tpos.astype(np.int64)].astype(np.uint64) @ w8
        )
    return kwords, ~ts, ~ri.astype(np.uint32)


def _gather_timestamps(runs, run_base, off_cat, sel):
    """Per-record int64-ns timestamps (as u64 bit views) for the
    GLOBAL indices ``sel`` — gathered lazily, because the pipeline
    never materializes a full timestamp column; only gc_grace needs
    them, and only for drop-candidate tombstones (a small fraction)."""
    ri = (
        np.searchsorted(run_base, sel, side="right") - 1
    ).astype(np.int64)
    off = off_cat[sel]
    ts = np.zeros(sel.size, dtype=np.uint64)
    w8 = np.uint64(1) << (
        np.arange(8, dtype=np.uint64) * np.uint64(8)
    )
    for r in np.unique(ri):
        msk = ri == r
        tpos = (off[msk] + np.uint64(8))[:, None] + np.arange(
            8, dtype=np.uint64
        )
        ts[msk] = (
            runs[r].data[tpos.astype(np.int64)].astype(np.uint64)
            @ w8
        )
    return ts


def _pipeline_merge_impl(
    sources: Sequence,
    dir_path: str,
    output_index: int,
    keep_tombstones: bool,
    bloom_min_size: int,
    device: torch.device,
    throttle=None,
    tombstone_drop_before: "int | None" = None,
    mesh=None,
) -> Optional[MergeResult]:
    from ..storage import native as native_mod
    from .bitonic import (
        merge_runs_prefix32_packed_batch_kernel,
        merge_runs_prefix64_packed_batch_kernel,
        rid_pack_bits,
    )

    on_card = device.type == "cuda"
    lib = native_mod.load()
    if lib is None:
        if on_card:
            raise RuntimeError(
                "native library (make -C native) unavailable: the "
                "compaction pipeline cannot run"
            )
        return None

    import os as _os
    import sys as _sys
    import time as _time

    _dbg = bool(_os.environ.get("DBEEL_PIPE_DEBUG"))
    _t0 = _time.perf_counter()

    def _ev(msg):
        # Stage-event tracing (DBEEL_PIPE_DEBUG=1): timestamps for
        # read/stage, launches, d2h, per-partition consume, writer
        # puts, background syncs and close.
        if _dbg:
            print(
                f"[pipe {_time.perf_counter() - _t0:7.3f}] {msg}",
                file=_sys.stderr,
                flush=True,
            )

    # ---- host staging (index columns + O_DIRECT data reads) ---------
    # IO threads read ahead (O_DIRECT, GIL released inside the C
    # call) while this thread stages completed runs' prefixes.  Two
    # readers by default (DBEEL_PIPE_READERS overrides).
    from concurrent.futures import ThreadPoolExecutor

    n_readers = max(
        1, int(_os.environ.get("DBEEL_PIPE_READERS", "2") or 2)
    )
    with ThreadPoolExecutor(max_workers=n_readers) as io:
        futs = [io.submit(_read_run, lib, s) for s in sources]
        runs = []
        for f in futs:
            r = f.result()
            _stage_prefixes(r, lib)
            runs.append(r)
    # Mesh mode: widen the launch batch to a partition multiple and
    # split the batch axis — each partition's device merges its own
    # keyspace partitions.  Computed BEFORE partitioning: the
    # multi-batch preference must target the EFFECTIVE launch width.
    launch_j = _LAUNCH_BATCH
    devs = [device]
    if mesh is not None and mesh.size > 1:
        devs = list(mesh.devices)
        if {d.type for d in devs} != {device.type}:
            raise ValueError(f"mesh {devs} does not run on {device.type}")
        launch_j = len(devs) * max(1, _LAUNCH_BATCH // len(devs))

    chosen = _choose_partitions(runs, launch_j)
    if chosen is None:
        return None
    _splitters, bounds, p2 = chosen
    _ev("prologue done (read+stage+choose)")
    n_parts = (bounds[0].size - 1) if bounds is not None else 0
    k2 = _pow2(max(1, len(runs)))
    pack_bits = rid_pack_bits(k2)

    counts_all = np.array(
        [r.offsets.size for r in runs], dtype=np.int64
    )
    run_base = np.zeros(len(runs) + 1, dtype=np.int64)
    np.cumsum(counts_all, out=run_base[1:])

    off_cat = (
        np.concatenate([r.offsets for r in runs])
        if runs
        else np.zeros(0, np.uint64)
    )
    ks_cat = (
        np.concatenate([r.key_size for r in runs])
        if runs
        else np.zeros(0, np.uint32)
    )
    fs_cat = (
        np.concatenate([r.full_size for r in runs])
        if runs
        else np.zeros(0, np.uint32)
    )
    # Native-endian u64 prefixes: one bulk byteswap here replaces the
    # per-partition BE->native astype in the consume loop AND feeds
    # the native decoder directly.
    pf_cat = (
        np.concatenate([r.prefix64 for r in runs]).astype(np.uint64)
        if runs
        else np.zeros(0, np.uint64)
    )
    tomb_cat = fs_cat == ks_cat + np.uint32(ENTRY_HEADER_SIZE)

    data_path = f"{dir_path}/{file_name(output_index, COMPACT_DATA_FILE_EXT)}"
    index_path = f"{dir_path}/{file_name(output_index, COMPACT_INDEX_FILE_EXT)}"
    # Single-pass sidecar: the gather writer's inline page-CRC
    # accumulators write the .sums sidecar from the bytes AS they
    # streamed through — no post-hoc triplet re-read.
    handle = lib.dbeel_writer_open2(
        data_path.encode(), index_path.encode(), 1
    )
    if not handle:
        raise _PipelineError(f"native writer open failed for {data_path}")

    total_input = int(sum(r.size for r in runs))
    collect_bloom = total_input >= bloom_min_size
    bloom_sel: List[np.ndarray] = []

    run_ptrs = (ctypes.POINTER(ctypes.c_uint8) * max(1, len(runs)))(
        *[
            r.data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
            for r in runs
        ]
    )

    # ---- pipeline threads -------------------------------------------
    # Per-partition permits, sized for two full launch batches in
    # flight (the upload thread holds up to launch_j permits while
    # assembling a batch, so the pool must exceed one batch or
    # assembly itself would deadlock).
    in_flight = threading.Semaphore(2 * launch_j)
    kernel_q: "queue.Queue" = queue.Queue()
    order_q: "queue.Queue" = queue.Queue()
    stop = threading.Event()
    # Side streams on each device: uploads + kernels on one, downloads
    # on the other, so batch b+1's host→device copy and kernel overlap
    # batch b's device→host copy.
    up_streams = {d: torch.cuda.Stream(d) for d in devs} if on_card else {}
    down_streams = (
        {d: torch.cuda.Stream(d) for d in devs} if on_card else {}
    )
    slot_span = launch_j // len(devs)  # slots per device in a batch

    def _staging(shape):
        """Host staging buffer (u32 view + its tensor): pinned on a
        card so the copies run asynchronously."""
        t = torch.empty(shape, dtype=torch.int32, pin_memory=on_card)
        return t.numpy().view(np.uint32), t

    def _launch_batch(metas, hosts, mode32):
        """One launch per device over up to ``launch_j`` same-mode
        partitions, empty-slot padded to a single shape, each device
        taking its ``slot_span`` slots.  On a card: pinned host buffers →
        device copies and the kernel on the device's up stream, with an
        event recorded after the launch; the queue item keeps every
        buffer alive until the download has waited on those events."""
        j = launch_j
        stack, stack_t = _staging(
            (j, k2, p2) if mode32 else (j, k2, p2, 2)
        )
        counts, counts_t = _staging((j, k2))
        stack.fill(SENTINEL)
        counts.fill(0)
        for slot, (meta, host) in enumerate(zip(metas, hosts)):
            stack[slot] = host
            counts[slot] = meta[1]
        _ev(f"launch batch parts={[m[0] for m in metas]} mode32={mode32}")
        kernel = (
            merge_runs_prefix32_packed_batch_kernel
            if mode32
            else merge_runs_prefix64_packed_batch_kernel
        )
        launched = []  # (device, out, done event) in slot order
        keep = [stack_t, counts_t]
        for s, dev in enumerate(devs):
            slots = slice(s * slot_span, (s + 1) * slot_span)
            if on_card:
                stream = up_streams[dev]
                with torch.cuda.stream(stream):
                    dev_stack = stack_t[slots].to(dev, non_blocking=True)
                    dev_cnt = counts_t[slots].to(dev, non_blocking=True)
                    out = kernel(dev_stack, dev_cnt, pack_bits)
                    done = torch.cuda.Event()
                    done.record(stream)
                keep += [dev_stack, dev_cnt]
            else:
                out = kernel(stack_t[slots], counts_t[slots], pack_bits)
                done = None
            launched.append((dev, out, done))
        _ev(f"dispatched batch parts={[m[0] for m in metas]}")
        kernel_q.put((metas, launched, keep))

    def _fetch(launched) -> np.ndarray:
        """Packed run ids to the host in slot order: per launch, wait
        on its event, then a device→host copy into pinned memory on the
        device's down stream."""
        if not on_card:
            words = [out.numpy().view(np.uint32) for _, out, _ in launched]
        else:
            fetches = []
            for dev, out, done in launched:
                done.synchronize()
                host = torch.empty(
                    out.shape, dtype=torch.int32, pin_memory=True
                )
                stream = down_streams[dev]
                with torch.cuda.stream(stream):
                    out.record_stream(stream)
                    host.copy_(out, non_blocking=True)
                    fetched = torch.cuda.Event()
                    fetched.record(stream)
                fetches.append((host, fetched))
            words = []
            for host, fetched in fetches:
                fetched.synchronize()
                words.append(host.numpy().view(np.uint32))
        return words[0] if len(words) == 1 else np.concatenate(words)

    def upload():
        try:
            metas: list = []  # (p, counts, los, mode32, minpf, shift)
            hosts: list = []
            batch_mode = True

            def flush():
                nonlocal metas, hosts
                if metas:
                    _launch_batch(metas, hosts, batch_mode)
                    metas, hosts = [], []

            for p in range(n_parts):
                # Timed acquire + stop checks: if the downloader dies
                # it can never release permits, and this thread must
                # not park forever pinning the run buffers.
                while not in_flight.acquire(timeout=0.25):
                    if stop.is_set():
                        return
                if stop.is_set():
                    return
                host, counts, los, mode32, minpf, shift = (
                    _partition_operand(runs, bounds, p, k2, p2)
                )
                if host is None:
                    # Keep strict partition order: launch whatever is
                    # pending first, THEN the empty marker (the
                    # downloader releases this partition's permit).
                    flush()
                    kernel_q.put(([(p, counts, los, True, 0, 0)], None, None))
                    continue
                if metas and mode32 != batch_mode:
                    flush()
                batch_mode = mode32
                metas.append((p, counts, los, mode32, minpf, shift))
                hosts.append(host)
                if len(metas) == launch_j:
                    flush()
            flush()
            kernel_q.put(None)
        except BaseException as e:  # propagate to writer
            kernel_q.put(e)

    def download():
        try:
            while True:
                # Timed get + stop check: on a consumer-side abort no
                # sentinel may ever arrive, and this thread must not
                # park forever (it would leak and stall the joins).
                try:
                    item = kernel_q.get(timeout=0.25)
                except queue.Empty:
                    if stop.is_set():
                        return
                    continue
                if item is None:
                    order_q.put(None)
                    return
                if isinstance(item, BaseException):
                    stop.set()
                    order_q.put(item)
                    return
                metas, launched, _keep = item
                if launched is not None:
                    _ev(f"d2h start parts={[m[0] for m in metas]}")
                    words = _fetch(launched)  # bit-packed run ids
                    _ev(f"d2h done parts={[m[0] for m in metas]}")
                    del item, launched, _keep
                    for slot, meta in enumerate(metas):
                        in_flight.release()
                        order_q.put((meta, words[slot]))
                else:
                    in_flight.release()  # re-balance the empty slot
                    order_q.put((metas[0], None))
        except BaseException as e:
            stop.set()
            order_q.put(e)

    t_up = threading.Thread(target=upload, daemon=True)
    t_down = threading.Thread(target=download, daemon=True)
    t_up.start()
    t_down.start()

    # Writer thread: native gather-writes run off the decode thread so
    # partition p+1's permutation rebuild overlaps partition p's disk
    # write (the ctypes call releases the GIL).  A sync thread
    # periodically fdatasyncs the data file CONCURRENTLY with the
    # writes, so the device write-cache flush pipelines behind the
    # stream instead of landing as one multi-second close_sync tail.
    write_q: "queue.Queue" = queue.Queue(maxsize=4)
    writer_state = {"wrote": 0, "bytes": 0, "error": None}

    def writer():
        try:
            while True:
                try:
                    job = write_q.get(timeout=0.25)
                except queue.Empty:
                    if stop.is_set():
                        return
                    continue
                if job is None:
                    return
                sel_sz, args, nbytes, _arrays = job
                rc = lib.dbeel_writer_put(handle, run_ptrs, *args)
                if rc != 0:
                    writer_state["error"] = _PipelineError(
                        "native gather-write failed"
                    )
                    stop.set()
                    return
                writer_state["wrote"] += sel_sz
                writer_state["bytes"] += nbytes
                _ev(f"writer put done ({writer_state['bytes']>>20}MB)")
        except BaseException as e:
            writer_state["error"] = e
            stop.set()

    sync_done = threading.Event()

    def syncer():
        # Flush ~every _SYNC_STRIDE of new bytes; safe concurrently
        # with dbeel_writer_put (see dbeel_writer_sync).
        last = 0
        while not sync_done.wait(0.2):
            b = writer_state["bytes"]
            if b - last >= _SYNC_STRIDE:
                lib.dbeel_writer_sync(handle)
                last = b
                _ev(f"bg sync at {b>>20}MB")

    t_write = threading.Thread(target=writer, daemon=True)
    t_write.start()
    t_sync = None
    if _SYNC_STRIDE > 0:  # else disabled: one flush at close only
        t_sync = threading.Thread(target=syncer, daemon=True)
        t_sync.start()

    try:
        expected = 0
        while True:
            # Timed get: the writer thread can fail and set ``stop``
            # without ever feeding order_q (it is not part of the
            # upload->download chain), so an untimed get could park
            # this thread forever on e.g. a full disk.
            while True:
                try:
                    item = order_q.get(timeout=0.25)
                    break
                except queue.Empty:
                    if writer_state["error"] is not None:
                        raise writer_state["error"]
                    if stop.is_set():
                        raise _PipelineError("pipeline stopped")
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            (p, counts, los, mode32, minpf, shift), packed = item
            _ev(f"consume start p={p}")
            if writer_state["error"] is not None:
                raise writer_state["error"]
            assert p == expected
            expected += 1
            n_p = int(counts.sum())
            if n_p == 0:
                continue
            # One C pass: unpack rids, per-run counters ->
            # permutation (each run's survivors appear in increasing
            # position order), device-key tie flags.
            gidx = np.empty(n_p, dtype=np.int64)
            rids32 = np.empty(n_p, dtype=np.uint32)
            tieb = np.empty(n_p, dtype=np.uint8)
            packed_c = np.ascontiguousarray(packed)
            cnts_c = np.ascontiguousarray(
                counts[: len(runs)], dtype=np.uint32
            )
            los_c = np.ascontiguousarray(los, dtype=np.int64)
            rc = lib.dbeel_pipe_decode(
                packed_c.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_uint32)
                ),
                ctypes.c_uint64(n_p),
                ctypes.c_uint32(pack_bits),
                ctypes.c_uint32(len(runs)),
                cnts_c.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_uint32)
                ),
                los_c.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_int64)
                ),
                run_base.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_int64)
                ),
                pf_cat.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_uint64)
                ),
                ctypes.c_uint64(minpf),
                ctypes.c_uint32(shift),
                1 if mode32 else 0,
                gidx.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_int64)
                ),
                rids32.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_uint32)
                ),
                tieb.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_uint8)
                ),
            )
            if rc != 0:
                raise _PipelineError(
                    "packed run-id decode mismatch"
                )
            flags = tieb[1:].view(np.bool_)

            # Tie blocks: adjacent entries equal under the DEVICE sort
            # key (shifted u32 or exact 8B prefix) are re-ordered by
            # (full key, newest ts, newest src) — one vectorized
            # lexsort — and duplicate keys are marked for dedup.
            keep = np.ones(n_p, dtype=bool)
            positions, block_id = columnar.tie_positions_and_blocks(
                flags
            )
            if positions.size:
                sel_t = gidx[positions]
                ks_t = ks_cat[sel_t]
                ent_w = columnar.tie_block_widths(block_id, ks_t)
                for w in np.unique(ent_w):
                    bm = ent_w == w
                    kwords, inv_ts, inv_src = _gather_tie_arrays(
                        runs,
                        run_base,
                        off_cat,
                        ks_cat,
                        sel_t[bm],
                        int(w),
                    )
                    order, dup = columnar.tie_block_sort(
                        block_id[bm], kwords, ks_t[bm], inv_ts, inv_src
                    )
                    gidx[positions[bm]] = sel_t[bm][order]
                    # The reorder moved entries across runs: refresh
                    # the run-id column at exactly those positions.
                    rids32[positions[bm]] = (
                        np.searchsorted(
                            run_base, gidx[positions[bm]], side="right"
                        )
                        - 1
                    ).astype(np.uint32)
                    keep[positions[bm]] = ~dup

            if not keep_tombstones:
                drop = tomb_cat[gidx]
                if tombstone_drop_before and drop.any():
                    # gc_grace: tombstones younger than the cutoff
                    # survive the drop.  Timestamps are gathered only
                    # for the drop candidates.
                    drop = drop.copy()
                    cand = np.flatnonzero(drop)
                    cand_ts = _gather_timestamps(
                        runs, run_base, off_cat, gidx[cand]
                    )
                    drop[
                        cand[
                            cand_ts
                            >= np.uint64(tombstone_drop_before)
                        ]
                    ] = False
                keep &= ~drop
            if not keep.all():
                sel = gidx[keep]
                src_run = np.ascontiguousarray(rids32[keep])
            else:
                sel = gidx
                src_run = np.ascontiguousarray(rids32)
            if sel.size == 0:
                continue
            src_off = np.ascontiguousarray(off_cat[sel])
            ks_sel = np.ascontiguousarray(ks_cat[sel])
            fs_sel = np.ascontiguousarray(fs_cat[sel])
            args = (
                src_run.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                src_off.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                ks_sel.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                fs_sel.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                ctypes.c_uint64(sel.size),
            )
            nbytes = int(fs_sel.sum())
            # The queue item carries the numpy arrays so they stay
            # alive exactly until the writer thread has consumed the
            # raw pointers (the bounded queue caps live jobs).
            job = (
                int(sel.size),
                args,
                nbytes,
                (src_run, src_off, ks_sel, fs_sel),
            )
            while True:
                try:
                    write_q.put(job, timeout=0.25)
                    break
                except queue.Full:
                    if stop.is_set() or writer_state["error"]:
                        raise writer_state["error"] or _PipelineError(
                            "writer stopped"
                        )
            _ev(f"consume done p={p}")
            if throttle is not None:
                # Latency class: one partition is the consume quantum —
                # pay back CPU to serving between partitions.
                throttle.tick()
            if collect_bloom:
                bloom_sel.append(sel)
        write_q.put(None)
        t_write.join(timeout=600)
        if writer_state["error"] is not None:
            raise writer_state["error"]
    except BaseException:
        stop.set()
        t_write.join(timeout=60)
        sync_done.set()
        if t_sync is not None:
            t_sync.join(timeout=60)
        if t_write.is_alive() or (
            t_sync is not None and t_sync.is_alive()
        ):
            # A wedged writer/sync thread may still hold the native
            # handle: leak it (and the partial files) rather than
            # free memory under a live pwrite/fdatasync.
            log.error(
                "pipeline writer/sync thread wedged; leaking native "
                "writer handle for %s", data_path
            )
        else:
            lib.dbeel_writer_abort(handle)
            _unlink_quiet(data_path, index_path)
        raise
    finally:
        _ev("joining threads")
        t_up.join(timeout=60)
        t_down.join(timeout=60)

    sync_done.set()
    if t_sync is not None:
        t_sync.join(timeout=60)
    if t_write.is_alive() or (
        t_sync is not None and t_sync.is_alive()
    ):
        log.error(
            "pipeline writer/sync thread wedged at close; leaking "
            "native writer handle for %s", data_path
        )
        raise _PipelineError("writer thread wedged")
    # Close (final fdatasync + truncate) runs on a thread so the
    # bloom build overlaps the device write-cache flush.  The bloom
    # reads only the INPUT runs — never the output file — and the
    # entry/byte counts are already known from the writer's own
    # accounting, so nothing here depends on close completing.
    _ev("writer close (async)")
    data_size = ctypes.c_uint64(0)
    close_ret = {"entries": -1, "crcs": None}
    # CRC handoff caps: the merged output can never exceed the sum of
    # its inputs (dedup/tombstone-drop only shrink it).
    _dcap = int(sum(r.size for r in runs)) // 4096 + 2
    _icap = int(run_base[-1]) * 16 // 4096 + 2

    def _close():
        dcrc = (ctypes.c_uint32 * _dcap)()
        icrc = (ctypes.c_uint32 * _icap)()
        nd = ctypes.c_uint64(0)
        ni = ctypes.c_uint64(0)
        rc = lib.dbeel_writer_close2(
            handle,
            ctypes.byref(data_size),
            dcrc,
            _dcap,
            icrc,
            _icap,
            ctypes.byref(nd),
            ctypes.byref(ni),
        )
        if rc == -2:
            # Triplet closed fine; only the CRC handoff was refused —
            # the LSM's counted post-hoc sidecar covers it.  Entries
            # are known from the writer's own accounting.
            close_ret["entries"] = writer_state["wrote"]
        else:
            close_ret["entries"] = rc
            if rc >= 0:
                close_ret["crcs"] = (
                    list(dcrc[: nd.value]),
                    list(icrc[: ni.value]),
                )

    t_close = threading.Thread(target=_close, daemon=True)
    t_close.start()

    entries = writer_state["wrote"]
    wrote_bloom = False
    bloom_blob = None
    from ..storage.compaction import COMPACT_BLOOM_FILE_EXT

    bloom_path = (
        f"{dir_path}/{file_name(output_index, COMPACT_BLOOM_FILE_EXT)}"
    )
    try:
        if writer_state["bytes"] >= bloom_min_size and entries > 0:
            from ..storage.bloom import BloomFilter, _SEED1, _SEED2

            bloom = BloomFilter.with_capacity(int(entries))
            all_sel = (
                np.concatenate(bloom_sel)
                if bloom_sel
                else np.zeros(0, np.int64)
            )
            for ri, r in enumerate(runs):
                mask = (all_sel >= run_base[ri]) & (
                    all_sel < run_base[ri + 1]
                )
                if not mask.any():
                    continue
                sel_r = all_sel[mask]
                offs = np.ascontiguousarray(
                    off_cat[sel_r] + np.uint64(ENTRY_HEADER_SIZE)
                )
                lens = np.ascontiguousarray(ks_cat[sel_r])
                lib.dbeel_bloom_add_batch(
                    bloom.bits.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_uint8)
                    ),
                    ctypes.c_uint64(bloom.num_bits),
                    ctypes.c_uint32(bloom.num_hashes),
                    r.data.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_uint8)
                    ),
                    offs.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_uint64)
                    ),
                    lens.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_uint32)
                    ),
                    ctypes.c_uint64(sel_r.size),
                    ctypes.c_uint32(_SEED1),
                    ctypes.c_uint32(_SEED2),
                )
            bloom_blob = _write_bloom(dir_path, output_index, bloom)
            wrote_bloom = True
    except BaseException:
        # The merge's contract is the whole triplet: a failed bloom
        # build (ENOSPC, MemoryError) must not leave the data/index
        # behind looking complete.  Join the async close first — never
        # unlink under a live fdatasync/truncate.
        t_close.join(timeout=600)
        if not t_close.is_alive():
            _unlink_quiet(data_path, index_path, bloom_path)
        raise

    t_close.join(timeout=600)
    _ev("writer closed")
    if t_close.is_alive():
        log.error(
            "pipeline writer close wedged; leaking native writer "
            "handle for %s", data_path
        )
        raise _PipelineError("writer close wedged")
    if close_ret["entries"] < 0:
        _unlink_quiet(data_path, index_path, bloom_path)
        raise _PipelineError("native writer close failed")
    assert close_ret["entries"] == entries
    assert int(data_size.value) == writer_state["bytes"]

    if close_ret["crcs"] is not None:
        # Single-pass sidecar: the per-page CRCs streamed out of the
        # gather writer; the bloom blob is still in RAM.  Written
        # under the same journaled rename as the triplet.
        from ..storage import checksums

        dcrcs, icrcs = close_ret["crcs"]
        checksums.write_crcs(
            dir_path,
            output_index,
            dcrcs,
            icrcs,
            int(data_size.value),
            zlib.crc32(bloom_blob) if bloom_blob is not None else 0,
            bloom_blob is not None,
            ext=checksums.COMPACT_SUMS_FILE_EXT,
        )

    return MergeResult(int(entries), int(data_size.value), wrote_bloom)
