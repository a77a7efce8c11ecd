"""ctypes bindings for the C++ host runtime (``native/``), and the
``native`` merge backend.

``native/`` is the shared C++ host runtime of the repository, not part
of either Python package: it is built with ``make -C native`` into
``native/build/libdbeel_native.so`` on first use (under an flock, so
concurrent processes wait for one build) and loaded as it is.  The port
binds what it calls:

* the compaction pipeline's O_DIRECT reads, prefix staging, gather
  writer, packed run-id decode and batch bloom build (``ops/pipeline.py``);
* the batch murmur3 hash the scan stage keys its arc filter on
  (``storage/range_digest.py``) and the scalar one (``utils/murmur.py``);
* the arena memtable and its single-pass flush (``storage/memtable.py``);
* the WAL appender, its group-commit syncer and the io_uring sync hub
  (``storage/wal.py``);
* the io_uring page reader of cold point reads (``storage/uring.py``);
* the k-way merge, ``NativeMergeStrategy`` below, with its chunked and
  overlapped file IO and the page-CRC kernel of the inline sidecar;
* the serving data plane (``dbeel_dp_*``, ``server/dataplane.py``) and
  the quorum fan-out engine (``dbeel_qf_*``, ``cluster/native_fanout.py``);
* the C smart client (``dbeel_cli_*``, ``client/native_client.py``).

The library must carry every one of these symbols (the current ABI); a
library without them is not used.

``DBEEL_NATIVE_SO`` selects another prebuilt library (the sanitizer
workflow loads ``build/libdbeel_native_asan.so``, made with ``make
SANITIZE=asan``).  An overridden path is loaded as it is — no staleness
check, no rebuild, which would clobber an instrumented binary with a
plain one — and any failure to load it raises, in every call.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from .bloom import BloomFilter, _SEED1, _SEED2
from .compaction import (
    CompactionStrategy,
    MergeResult,
    _write_bloom,
)
from .entry import (
    COMPACT_DATA_FILE_EXT,
    COMPACT_INDEX_FILE_EXT,
    COMPACT_SUMS_FILE_EXT,
    DATA_FILE_EXT,
    INDEX_FILE_EXT,
    PAGE_SIZE,
    file_name,
)
from .file_io import PageMirroringWriter

log = logging.getLogger(__name__)

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "native"
)
DEFAULT_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libdbeel_native.so")
LIB_PATH = os.environ.get("DBEEL_NATIVE_SO") or DEFAULT_LIB_PATH
LIB_OVERRIDDEN = LIB_PATH != DEFAULT_LIB_PATH

# Outputs of the native merge at or above this size are written by the
# C O_DIRECT streamer; smaller ones through the page-mirroring writer,
# so fresh little tables stay warm in the page cache.
ODIRECT_MIN_BYTES = 64 << 20

# The merge calls back into Python (the throttle's tick) every
# _MERGE_TICK_EVERY popped entries; its file IO every _IO_CHUNK_BYTES —
# small enough that a BgThrottle can pace the burst against serving,
# large enough to keep near-sequential disk bandwidth.
TICK_FN = ctypes.CFUNCTYPE(None)
_MERGE_TICK_EVERY = 65536
_IO_CHUNK_BYTES = 16 << 20

_vp, _cp = ctypes.c_void_p, ctypes.c_char_p
_int, _i32, _i64 = ctypes.c_int, ctypes.c_int32, ctypes.c_int64
_u16, _u32, _u64 = ctypes.c_uint16, ctypes.c_uint32, ctypes.c_uint64
_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(_u32)
_u64p = ctypes.POINTER(_u64)
_cpp = ctypes.POINTER(_cp)
# (data pointers, index pointers, counts, n_sources, keep_tombstones)
# and (out_data, out_size, out_index) of the merges.
_MERGE_IN = [_cpp, _cpp, _u64p, _u32, _int]
_MERGE_OUT = [_u8p, _u64p, _u8p]
# (handle, frame, frame length, out buffer, capacity, out length) of the
# data plane's three frame handlers.
_DP_HANDLER = [_vp, _cp, _u32, _cp, _u32, _u32p]

# Every symbol the port calls: (restype, argtypes).  argtypes None —
# the caller passes fully typed ctypes arguments (ops/pipeline.py).
# A library lacking any of them is not used.
_PROTOTYPES = {
    # The compaction pipeline and the scan stage.
    "dbeel_read_file": (_i64, [_cp, _u8p, _u64]),
    "dbeel_stage_prefixes": (
        None, [_u8p, _u64, _u64p, _u32p, _u64, _u64, _u8p]
    ),
    "dbeel_writer_open": (_vp, [_cp, _cp]),
    "dbeel_writer_open2": (_vp, [_cp, _cp, _i32]),
    "dbeel_writer_put": (
        _i64, [_vp, ctypes.POINTER(_u8p), _u32p, _u64p, _u32p, _u32p, _u64]
    ),
    "dbeel_writer_sync": (None, [_vp]),
    "dbeel_writer_close": (_i64, [_vp, _u64p]),
    "dbeel_writer_close2": (
        _i64, [_vp, _u64p, _u32p, _u64, _u32p, _u64, _u64p, _u64p]
    ),
    "dbeel_writer_abort": (None, [_vp]),
    "dbeel_pipe_decode": (_int, None),
    "dbeel_bloom_add_batch": (None, None),
    "dbeel_murmur3_32": (_u32, [_cp, _u64, _u32]),
    "dbeel_murmur3_32_batch": (None, [_cp, _u64p, _u32p, _u64, _u32, _u32p]),
    # The arena memtable and its flush.
    "dbeel_memtable_new": (_vp, [_u32]),
    "dbeel_memtable_free": (None, [_vp]),
    "dbeel_memtable_set": (_i32, [_vp, _cp, _u32, _cp, _u32, _i64, _u32p]),
    "dbeel_memtable_get": (
        _i32, [_vp, _cp, _u32, ctypes.POINTER(_u8p), _u32p,
               ctypes.POINTER(_i64)]
    ),
    "dbeel_memtable_len": (_u32, [_vp]),
    "dbeel_memtable_bytes": (_u64, [_vp]),
    "dbeel_memtable_max_ts": (_i64, [_vp]),
    "dbeel_memtable_dump_size": (_u64, [_vp]),
    "dbeel_memtable_dump": (_u64, [_vp, _u8p]),
    "dbeel_memtable_flush_write": (_i64, [_vp, _cp, _u64, _u64]),
    "dbeel_memtable_flush_write2": (
        _i64, [_vp, _cp, _u64, _u64, _u32p, _u64, _u32p, _u64, _u64p,
               _u64p, _u32p, ctypes.POINTER(_i32)]
    ),
    # The WAL appender, its syncer and the sync hub.
    "dbeel_wal_new": (_vp, [_i32, _u64]),
    "dbeel_wal_free": (None, [_vp]),
    "dbeel_wal_append": (_u64, [_vp, _cp, _u32, _cp, _u32, _i64]),
    "dbeel_wal_offset": (_u64, [_vp]),
    "dbeel_wal_seq": (_u64, [_vp]),
    "dbeel_wal_synced": (_u64, [_vp]),
    "dbeel_wal_sync_enable": (_i32, [_vp, _u64, _i32]),
    "dbeel_wal_sync_disable": (None, [_vp]),
    "dbeel_wal_sync_attach": (_i32, [_vp, _vp, _u64]),
    "dbeel_wal_sync_stop_async": (None, [_vp]),
    "dbeel_walsync_hub_new": (_vp, [_u32]),
    "dbeel_walsync_hub_free": (None, [_vp]),
    "dbeel_walsync_hub_eventfd": (_i32, [_vp]),
    "dbeel_walsync_hub_reap": (None, [_vp]),
    "dbeel_walsync_errors": (_u64, []),
    # The io_uring page reader (storage/uring.py): (ring, fd, buffer,
    # length, offset, tag) for the reads.
    "dbeel_uring_create": (_vp, [ctypes.c_uint]),
    "dbeel_uring_destroy": (None, [_vp]),
    "dbeel_uring_eventfd": (_int, [_vp]),
    "dbeel_uring_queue_read": (_int, [_vp, _int, _vp, _u32, _u64, _u64]),
    "dbeel_uring_submit_read": (_int, [_vp, _int, _vp, _u32, _u64, _u64]),
    "dbeel_uring_flush": (_int, [_vp]),
    "dbeel_uring_reap": (
        _int, [_vp, _u64p, ctypes.POINTER(_i32), _int]
    ),
    # The k-way merge and its file IO.
    "dbeel_merge": (_i64, _MERGE_IN + _MERGE_OUT),
    "dbeel_merge_cb": (_i64, _MERGE_IN + _MERGE_OUT + [TICK_FN, _u64]),
    "dbeel_merge_grace_cb": (
        _i64, _MERGE_IN + [_i64] + _MERGE_OUT + [TICK_FN, _u64]
    ),
    "dbeel_read_file_cb": (_i64, [_cp, _u8p, _u64, TICK_FN, _u64]),
    "dbeel_read_files_overlapped": (
        _i64, [_cpp, ctypes.POINTER(_u8p), _u64p, _u32, TICK_FN, _u64]
    ),
    "dbeel_write_file": (_i64, [_cp, _u8p, _u64]),
    "dbeel_write_file_cb": (_i64, [_cp, _u8p, _u64, TICK_FN, _u64]),
    # Page CRCs and counters.
    "dbeel_crc32_pages": (None, [_u8p, _u64, _u32p]),
    "dbeel_odirect_fallbacks": (_u64, []),
    "dbeel_read_overlap_stats": (None, [_u64p, _u64p]),
    # The serving data plane: a handle per shard, collections registered
    # with their memtable, WAL and table descriptors; the handlers take
    # (dp, frame, frame length, out, out capacity, out length).
    "dbeel_dp_new": (_vp, []),
    "dbeel_dp_free": (None, [_vp]),
    "dbeel_dp_set_ownership": (None, [_vp, _i32, _u32, _u32]),
    # (dp, name, name length, active, flushing, wal, capacity,
    # client_plane — 0 = replica plane only)
    "dbeel_dp_register": (_i32, [_vp, _cp, _u32, _vp, _vp, _vp, _u32, _i32]),
    "dbeel_dp_unregister": (None, [_vp, _cp, _u32]),
    "dbeel_dp_set_watermark": (None, [_vp, _cp, _u32, _i64]),
    # (dp, name, name length, FastTable descriptor array, count)
    "dbeel_dp_set_tables": (_i32, [_vp, _cp, _u32, _vp, _i32]),
    "dbeel_dp_handle": (_i64, _DP_HANDLER),
    "dbeel_dp_handle_shard": (_i64, _DP_HANDLER),
    "dbeel_dp_handle_coord": (_i64, _DP_HANDLER),
    "dbeel_dp_set_overload": (None, [_vp, _i32]),
    "dbeel_dp_set_overload_resp": (None, [_vp, _cp, _u32, _cp, _u32]),
    "dbeel_dp_set_verify": (None, [_vp, _i32]),
    "dbeel_dp_set_multi": (None, [_vp, _i32]),
    "dbeel_dp_set_class_levels": (None, [_vp, _i32, _i32, _i32]),
    "dbeel_dp_sheds_by_class": (None, [_vp, _u64p]),
    "dbeel_dp_admits_by_class": (None, [_vp, _u64p]),
    "dbeel_dp_set_trace": (None, [_vp, _i32]),
    "dbeel_dp_trace_snapshot": (_i32, [_vp, _u64p, _i32]),
    **{
        f"dbeel_dp_{counter}": (_u64, [_vp])
        for counter in (
            "fast_sets", "fast_gets", "fast_table_gets", "fast_replica_ops",
            "fast_coord_writes", "fast_coord_gets", "fast_multi_sets",
            "fast_multi_gets", "native_sheds", "native_deadline_drops",
            "crc_failures",
        )
    },
    # The quorum fan-out engine: one stream per peer id.
    "dbeel_qf_new": (_vp, []),
    "dbeel_qf_free": (None, [_vp]),
    "dbeel_qf_set_stream": (_i32, [_vp, _i32, _i32]),
    "dbeel_qf_stream_alive": (_i32, [_vp, _i32]),
    "dbeel_qf_kill_stream": (None, [_vp, _i32]),
    "dbeel_qf_close_stream": (None, [_vp, _i32]),
    # (qf, frame, frame length, peer ids, n peers, expected ack, its
    # length) -> op id, 0 when nothing was sent
    "dbeel_qf_submit": (
        _u64, [_vp, _cp, _u32, ctypes.POINTER(_i32), _u32, _cp, _u32]
    ),
    "dbeel_qf_wants_write": (_i32, [_vp, _i32]),
    "dbeel_qf_on_writable": (_i32, [_vp, _i32]),
    "dbeel_qf_on_readable": (_i32, [_vp, _i32]),
    # (qf, op id, peer id, kind, payload buffer, capacity, length)
    "dbeel_qf_next_event": (
        _i32, [_vp, _u64p, ctypes.POINTER(_i32), ctypes.POINTER(_i32), _cp,
               _u32, _u32p]
    ),
    "dbeel_qf_fanout_ops": (_u64, [_vp]),
    # The C smart client (client/native_client.py): a handle per client;
    # keys and values are msgpack bytes with their lengths; (consistency,
    # rf) route each op; a buffer and its capacity take each answer.
    "dbeel_cli_new": (_vp, [_cp, _u16]),
    "dbeel_cli_free": (None, [_vp]),
    "dbeel_cli_sync": (_int, [_vp]),
    "dbeel_cli_ring_size": (_u64, [_vp]),
    "dbeel_cli_last_error": (_cp, [_vp]),
    # (client, op deadline ms, backoff base ms, backoff cap ms)
    "dbeel_cli_set_retry": (None, [_vp, _u32, _u32, _u32]),
    "dbeel_cli_create_collection": (_int, [_vp, _cp, _u32]),
    "dbeel_cli_create_collection_indexed": (_int, [_vp, _cp, _u32, _cp]),
    "dbeel_cli_set": (_int, [_vp, _cp, _u8p, _u32, _u8p, _u32, _int, _u32]),
    "dbeel_cli_delete": (_int, [_vp, _cp, _u8p, _u32, _int, _u32]),
    # (client, collection, key, value, delete, expected value, expect
    # absent, expected ts or -1, consistency, rf)
    "dbeel_cli_cas": (
        _int, [_vp, _cp, _u8p, _u32, _u8p, _u32, _int, _u8p, _u32, _int,
               _i64, _int, _u32]
    ),
    "dbeel_cli_get": (
        _i64, [_vp, _cp, _u8p, _u32, _int, _u32, _u8p, _u64]
    ),
    # The pipelined train: (..., consistency, rf, window).
    "dbeel_cli_pipe_set": (
        _int, [_vp, _cp, _u8p, _u32, _u8p, _u32, _int, _u32, _u32]
    ),
    "dbeel_cli_pipe_get": (_int, [_vp, _cp, _u8p, _u32, _int, _u32, _u32]),
    "dbeel_cli_pipe_drain": (_i64, [_vp]),
    "dbeel_cli_pipe_run": (
        _i64, [_vp, _cp, _int, _u8p, _u64, _u8p, _u64, _u32, _int, _u32,
               _u32]
    ),
    # (client, ip, port, out buffer, capacity) of the admin reads.
    **{
        f"dbeel_cli_{name}": (_i64, [_vp, _cp, _u16, _u8p, _u64])
        for name in ("get_stats", "cluster_stats", "trace_dump")
    },
    "dbeel_cli_set_trace": (None, [_vp, _u64]),
    "dbeel_cli_set_qos": (None, [_vp, _i32, _cp]),
    # (client, ip, port, collection, cursor, count only, prefix, limit,
    # max bytes, spec, out buffer, capacity)
    "dbeel_cli_scan_chunk": (
        _i64, [_vp, _cp, _u16, _cp, _u8p, _u32, _int, _u8p, _u32, _u64,
               _u64, _u8p, _u32, _u8p, _u64]
    ),
    # (client, collection, length-prefixed ops, their bytes, count,
    # consistency, rf, status out[, out buffer, capacity])
    "dbeel_cli_multi_set": (
        _i64, [_vp, _cp, _u8p, _u64, _u32, _int, _u32, _u8p]
    ),
    "dbeel_cli_multi_get": (
        _i64, [_vp, _cp, _u8p, _u64, _u32, _int, _u32, _u8p, _u64]
    ),
}
_REQUIRED = tuple(_PROTOTYPES)

_lib: Optional[ctypes.CDLL] = None
_tried = False
_guard = threading.Lock()


def _src_mtime() -> float:
    """Newest .cpp under native/src drives staleness."""
    src_dir = os.path.join(_NATIVE_DIR, "src")
    try:
        return max(
            os.path.getmtime(os.path.join(src_dir, f))
            for f in os.listdir(src_dir)
            if f.endswith(".cpp")
        )
    except (OSError, ValueError):
        return 0.0


def _stale() -> bool:
    """Missing or older than its sources; never for an override."""
    if LIB_OVERRIDDEN:
        return False
    return (
        not os.path.exists(LIB_PATH)
        or os.path.getmtime(LIB_PATH) < _src_mtime()
    )


def build() -> None:
    """``make -C native`` under an flock (``-B`` when the library is
    older than its sources).  Raises when the build fails."""
    import fcntl

    os.makedirs(os.path.join(_NATIVE_DIR, "build"), exist_ok=True)
    with open(os.path.join(_NATIVE_DIR, "build", ".lock"), "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        # Re-check under the lock: another process may have just
        # finished the same build.
        if _stale():
            rebuild = os.path.exists(LIB_PATH)
            subprocess.run(
                ["make", "-C", _NATIVE_DIR] + (["-B"] if rebuild else []),
                check=True,
                capture_output=True,
                timeout=300,
            )


def _bind(lib: ctypes.CDLL) -> None:
    for name, (restype, argtypes) in _PROTOTYPES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        if argtypes is not None:
            fn.argtypes = argtypes


def _unusable(why: str) -> None:
    """Log why the library is not used — or raise, for an override:
    an explicit ``DBEEL_NATIVE_SO`` that silently degraded would run a
    sanitized suite against no native code at all."""
    if LIB_OVERRIDDEN:
        raise RuntimeError(f"DBEEL_NATIVE_SO={LIB_PATH}: {why}")
    log.warning("native library: %s", why)


def load() -> Optional[ctypes.CDLL]:
    """The library, built first if missing or stale; None when it
    cannot be built or lacks a symbol of ``_PROTOTYPES``.  With
    ``DBEEL_NATIVE_SO`` set it raises instead of returning None."""
    global _lib, _tried
    with _guard:
        if _lib is not None:
            return _lib
        if _tried:
            if LIB_OVERRIDDEN:
                _unusable("failed to load earlier in this process")
            return None
        _tried = True
        if _stale():
            try:
                build()
            except Exception as e:
                log.warning("native build failed: %s", e)
                if not os.path.exists(LIB_PATH):
                    return None
        try:
            lib = ctypes.CDLL(LIB_PATH)
        except OSError as e:
            _unusable(f"load failed: {e}")
            return None
        missing = [s for s in _REQUIRED if not hasattr(lib, s)]
        if missing:
            _unusable("lacks " + ", ".join(missing))
            return None
        _bind(lib)
        _lib = lib
        return _lib


def load_if_built() -> Optional[ctypes.CDLL]:
    """The library only if already built — never runs make (safe from
    latency-sensitive contexts such as the first murmur hash).  An
    override goes straight to ``load()``, which never builds it and
    raises when it does not load."""
    if _lib is not None:
        return _lib
    if not LIB_OVERRIDDEN and not os.path.exists(LIB_PATH):
        return None
    return load()


def native_available() -> bool:
    return load() is not None


_odirect_warned = False


def odirect_fallbacks() -> int:
    """Process-wide count of O_DIRECT → buffered degradations in the C
    streamers (an unaligned destination buffer, a filesystem refusing
    O_DIRECT); the first non-zero reading logs a warning.  Never
    triggers a build: 0 while the library is not loaded."""
    global _odirect_warned
    lib = _lib
    if lib is None:
        return 0
    n = int(lib.dbeel_odirect_fallbacks())
    if n and not _odirect_warned:
        _odirect_warned = True
        log.warning(
            "O_DIRECT degraded to buffered I/O %d time(s) (unaligned "
            "buffer or filesystem without O_DIRECT support)", n,
        )
    return n


def read_overlap_stats() -> "tuple[int, int]":
    """(io_uring passes, serial passes) of the overlapped multi-file
    input loader.  Never triggers a build: (0, 0) while the library is
    not loaded."""
    lib = _lib
    if lib is None:
        return (0, 0)
    a = ctypes.c_uint64(0)
    b = ctypes.c_uint64(0)
    lib.dbeel_read_overlap_stats(ctypes.byref(a), ctypes.byref(b))
    return (int(a.value), int(b.value))


def aligned_u8_buffer(size: int) -> np.ndarray:
    """4 KiB-aligned uint8 destination of ``max(1, size)`` logical
    bytes with page-rounded capacity — what the O_DIRECT readers
    require (an unaligned buffer silently degrades to buffered IO)."""
    cap = (size + 4095) & ~4095
    raw = np.empty(cap + 4096, dtype=np.uint8)
    off = (-raw.ctypes.data) % 4096
    return raw[off: off + max(1, size)]


def page_crcs_native(lib, arr: np.ndarray, size: int) -> list:
    """Per-4 KiB-page CRCs of ``arr[:size]`` by the C kernel — the
    in-RAM half of the single-pass sidecar (the merged output is still
    resident; summing it here beats re-reading the file just written)."""
    npages = (size + PAGE_SIZE - 1) // PAGE_SIZE
    if npages == 0:
        return []
    out = np.zeros(npages, dtype=np.uint32)
    lib.dbeel_crc32_pages(
        arr.ctypes.data_as(_u8p),
        ctypes.c_uint64(int(size)),
        out.ctypes.data_as(_u32p),
    )
    return out.tolist()


def require() -> ctypes.CDLL:
    """The library; raises when it cannot be built (no silent fallback
    to a Python path)."""
    lib = load()
    if lib is None:
        raise RuntimeError(
            "native library (make -C native) unavailable: "
            f"{LIB_PATH} cannot be built or lacks the port's symbols"
        )
    return lib


def murmur3_32_native(data: bytes, seed: int = 0) -> int:
    """The C murmur3_32 of ``data`` (the parity hook of
    ``utils/murmur.py``'s pure-Python version); raises when the library
    cannot be built."""
    return require().dbeel_murmur3_32(data, len(data), seed)


_RECORD = np.dtype(
    [("offset", "<u8"), ("key_size", "<u4"), ("full_size", "<u4")]
)


class NativeMergeStrategy(CompactionStrategy):
    """The C++ k-way heap merge (``dbeel_merge*``): the heap strategy's
    semantics at native speed, with the batch bloom and the inline
    ``.sums`` sidecar computed from the still-resident output."""

    name = "native"

    def merge(
        self,
        sources,
        dir_path,
        output_index,
        cache,
        keep_tombstones,
        bloom_min_size,
    ) -> MergeResult:
        lib = require()
        throttle = self.throttle
        # Chunked, throttle-ticked IO: one unbroken multi-hundred-MB
        # read or write starves a serving loop; with a tick between
        # chunks the BgThrottle paces the burst.  TICK_FN() is a NULL
        # function pointer (no callback).
        tick_cb = (
            TICK_FN(throttle.tick) if throttle is not None else TICK_FN()
        )
        use_cb = throttle is not None

        def _read_whole(path: str, size: int):
            if not use_cb or size < _IO_CHUNK_BYTES * 2:
                with open(path, "rb") as f:
                    data = f.read(size)
                if len(data) != size:
                    # The merge sizes its buffers from the index: a
                    # truncated data file must fail here, not as an
                    # out-of-bounds read in C.
                    raise OSError(
                        f"short read {len(data)} != {size} for {path}"
                    )
                return data
            # 4 KiB-aligned so the chunked read takes O_DIRECT.
            buf = aligned_u8_buffer(size)
            got = lib.dbeel_read_file_cb(
                path.encode(),
                buf.ctypes.data_as(_u8p),
                ctypes.c_uint64(size),
                tick_cb,
                ctypes.c_uint64(_IO_CHUNK_BYTES),
            )
            if got != size:
                raise OSError(f"short read {got} != {size} for {path}")
            return buf

        # The overlapped input pass: every data and index file rides one
        # io_uring with double-buffered chunk reads (a serial fallback
        # inside the library is counted in read_overlap_stats).  Merges
        # under one chunk keep the serial reader.
        counts = [s.entry_count for s in sources]
        datas = indexes = None
        total_in = sum(s.data_size + s.entry_count * 16 for s in sources)
        if total_in >= _IO_CHUNK_BYTES:
            paths = [s.data_path for s in sources] + [
                s.index_path for s in sources
            ]
            sizes = [s.data_size for s in sources] + [
                s.entry_count * 16 for s in sources
            ]
            bufs = [aligned_u8_buffer(sz) for sz in sizes]
            got = lib.dbeel_read_files_overlapped(
                (ctypes.c_char_p * len(paths))(
                    *[p.encode() for p in paths]
                ),
                (_u8p * len(paths))(
                    *[b.ctypes.data_as(_u8p) for b in bufs]
                ),
                (ctypes.c_uint64 * len(paths))(*sizes),
                len(paths),
                tick_cb,
                ctypes.c_uint64(_IO_CHUNK_BYTES),
            )
            if got == sum(sizes):
                datas = bufs[: len(sources)]
                indexes = bufs[len(sources):]
            else:
                log.warning(
                    "overlapped input read failed (%d); serial reads", got
                )
        if datas is None or indexes is None:
            datas = [_read_whole(s.data_path, s.data_size) for s in sources]
            indexes = [
                _read_whole(s.index_path, s.entry_count * 16)
                for s in sources
            ]

        total_data = sum(s.data_size for s in sources)
        out_data = np.zeros(max(1, total_data), dtype=np.uint8)
        out_index = np.zeros(max(1, sum(counts) * 16), dtype=np.uint8)
        out_size = ctypes.c_uint64(0)

        def _as_cptr(b):
            if isinstance(b, np.ndarray):
                return ctypes.cast(b.ctypes.data_as(_u8p), ctypes.c_char_p)
            return ctypes.c_char_p(b)

        ptrs = ctypes.c_char_p * len(sources)
        head = (
            ptrs(*[_as_cptr(d) for d in datas]),
            ptrs(*[_as_cptr(i) for i in indexes]),
            (ctypes.c_uint64 * len(sources))(*counts),
            len(sources),
            1 if keep_tombstones else 0,
        )
        out = (
            out_data.ctypes.data_as(_u8p),
            ctypes.byref(out_size),
            out_index.ctypes.data_as(_u8p),
        )
        cutoff = int(self.tombstone_drop_before or 0)
        if not keep_tombstones and cutoff > 0:
            # gc_grace: tombstones at or after the cutoff survive the
            # drop.
            n_out = lib.dbeel_merge_grace_cb(
                *head, ctypes.c_int64(cutoff), *out, tick_cb,
                _MERGE_TICK_EVERY,
            )
        else:
            n_out = lib.dbeel_merge_cb(
                *head, *out, tick_cb, _MERGE_TICK_EVERY
            )
        n_out = int(n_out)
        data_size = int(out_size.value)
        self._tick()

        data_path = (
            f"{dir_path}/{file_name(output_index, COMPACT_DATA_FILE_EXT)}"
        )
        index_path = (
            f"{dir_path}/{file_name(output_index, COMPACT_INDEX_FILE_EXT)}"
        )
        if data_size >= ODIRECT_MIN_BYTES:
            # Large outputs: C O_DIRECT writes, no Python copies and no
            # page-cache mirroring.
            rcs = []
            for path, arr, size in (
                (data_path, out_data, data_size),
                (index_path, out_index, n_out * 16),
            ):
                if use_cb:
                    rcs.append(lib.dbeel_write_file_cb(
                        path.encode(), arr.ctypes.data_as(_u8p),
                        ctypes.c_uint64(size), tick_cb,
                        ctypes.c_uint64(_IO_CHUNK_BYTES),
                    ))
                else:
                    rcs.append(lib.dbeel_write_file(
                        path.encode(), arr.ctypes.data_as(_u8p),
                        ctypes.c_uint64(size),
                    ))
            if any(rcs):
                raise OSError("native O_DIRECT write failed")
        else:
            for path, ext, blob in (
                (data_path, DATA_FILE_EXT, out_data[:data_size]),
                (index_path, INDEX_FILE_EXT, out_index[: n_out * 16]),
            ):
                w = PageMirroringWriter(path, (ext, output_index), cache)
                w.write(blob.tobytes())
                w.close()

        wrote_bloom = False
        bloom_bytes = None
        if data_size >= bloom_min_size and n_out > 0:
            rec = np.frombuffer(out_index[: n_out * 16], dtype=_RECORD)
            bloom = BloomFilter.with_capacity(n_out)
            key_offsets = (rec["offset"] + 16).astype(np.uint64)
            key_lens = rec["key_size"].astype(np.uint32)
            lib.dbeel_bloom_add_batch(
                bloom.bits.ctypes.data_as(_u8p),
                ctypes.c_uint64(bloom.num_bits),
                ctypes.c_uint32(bloom.num_hashes),
                out_data.ctypes.data_as(_u8p),
                key_offsets.ctypes.data_as(_u64p),
                key_lens.ctypes.data_as(_u32p),
                ctypes.c_uint64(n_out),
                ctypes.c_uint32(_SEED1),
                ctypes.c_uint32(_SEED2),
            )
            bloom_bytes = _write_bloom(dir_path, output_index, bloom)
            wrote_bloom = True

        # The single-pass sidecar: the output is still resident, so it
        # is page-CRC'd in RAM and the compact_sums file rides the same
        # journaled rename as the triplet.
        from . import checksums

        checksums.write(
            dir_path,
            output_index,
            page_crcs_native(lib, out_data, data_size),
            page_crcs_native(lib, out_index, n_out * 16),
            data_size,
            bloom_bytes,
            ext=COMPACT_SUMS_FILE_EXT,
        )

        if self.index_fields and n_out > 0:
            # The index run is extracted from the same resident
            # out_data/out_index buffers the C merge just filled — like
            # the inline sidecar above, it adds zero data-file reads.
            from . import secondary_index as si

            rec = np.frombuffer(out_index[: n_out * 16], dtype=_RECORD)
            si.emit_run(
                dir_path,
                output_index,
                self.index_fields,
                si.rows_from_blob(out_data, rec, n_out),
                compact=True,
            )
        return MergeResult(n_out, data_size, wrote_bloom)
