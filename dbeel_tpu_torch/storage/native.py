"""ctypes bindings for the C++ host runtime (``native/``) — the part the
compaction pipeline calls.

``native/`` is the shared C++ host runtime of the repository, not part
of either Python package: it is built with ``make -C native`` into
``native/build/libdbeel_native.so`` on first use (under an flock, so
concurrent processes wait for one build) and loaded as it is.  Only the
prototypes the port calls are bound here: O_DIRECT file reads, prefix
staging, the gather writer, the packed run-id decode and the batch
bloom build (``ops/pipeline.py``), and the batch murmur3 hash the scan
stage keys its arc filter on (``storage/range_digest.py``).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional

log = logging.getLogger(__name__)

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "native"
)
LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libdbeel_native.so")

# The symbols the port needs; a library without them is not used.
_REQUIRED = (
    "dbeel_read_file",
    "dbeel_stage_prefixes",
    "dbeel_writer_open",
    "dbeel_writer_open2",
    "dbeel_writer_put",
    "dbeel_writer_sync",
    "dbeel_writer_close",
    "dbeel_writer_close2",
    "dbeel_writer_abort",
    "dbeel_pipe_decode",
    "dbeel_bloom_add_batch",
    "dbeel_murmur3_32_batch",
)

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
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.dbeel_read_file.restype = ctypes.c_int64
    lib.dbeel_read_file.argtypes = [ctypes.c_char_p, u8p, ctypes.c_uint64]
    lib.dbeel_stage_prefixes.restype = None
    lib.dbeel_stage_prefixes.argtypes = [
        u8p,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_uint64,
        ctypes.c_uint64,
        u8p,
    ]
    lib.dbeel_writer_open.restype = ctypes.c_void_p
    lib.dbeel_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.dbeel_writer_open2.restype = ctypes.c_void_p
    lib.dbeel_writer_open2.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_int32,
    ]
    lib.dbeel_writer_put.restype = ctypes.c_int64
    lib.dbeel_writer_put.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(u8p),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_uint64,
    ]
    lib.dbeel_writer_sync.restype = None
    lib.dbeel_writer_sync.argtypes = [ctypes.c_void_p]
    lib.dbeel_writer_close.restype = ctypes.c_int64
    lib.dbeel_writer_close.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.dbeel_writer_close2.restype = ctypes.c_int64
    lib.dbeel_writer_close2.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.dbeel_writer_abort.restype = None
    lib.dbeel_writer_abort.argtypes = [ctypes.c_void_p]
    # dbeel_pipe_decode and dbeel_bloom_add_batch are called with fully
    # typed ctypes arguments (ops/pipeline.py).
    lib.dbeel_pipe_decode.restype = ctypes.c_int
    lib.dbeel_bloom_add_batch.restype = None
    lib.dbeel_murmur3_32_batch.restype = None
    lib.dbeel_murmur3_32_batch.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_uint64,
        ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint32),
    ]
    if hasattr(lib, "dbeel_murmur3_32"):
        lib.dbeel_murmur3_32.restype = ctypes.c_uint32
        lib.dbeel_murmur3_32.argtypes = [
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_uint32,
        ]


def load() -> Optional[ctypes.CDLL]:
    """The library, built first if missing or stale; None when it
    cannot be built or lacks the pipeline's symbols."""
    global _lib, _tried
    with _guard:
        if _lib is not None or _tried:
            return _lib
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
            log.warning("native lib load failed: %s", e)
            return None
        missing = [s for s in _REQUIRED if not hasattr(lib, s)]
        if missing:
            log.warning("native library lacks %s", ", ".join(missing))
            return None
        _bind(lib)
        _lib = lib
        return _lib


def load_if_built() -> Optional[ctypes.CDLL]:
    """The library only if already built — never runs make (safe from
    latency-sensitive contexts such as the first murmur hash)."""
    if _lib is not None:
        return _lib
    if not os.path.exists(LIB_PATH):
        return None
    return load()
