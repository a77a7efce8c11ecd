"""Build and bind the CUDA kernels of ``csrc/``.

Route (b) of a hand-written kernel: ``nvcc`` compiles each source into
a shared library with a plain C interface, loaded with ctypes — one
library per source (``bitonic.cu``: the merge networks K4, K5 and K7;
``merge_path.cu``: the merge-path merges K1-K3 and K6; ``query.cu``:
the filter kernels K8; ``dist.cu``: the sample sort's bucket scatter
K9b, which also picks the splitters), so the builds run side by side
and a change to one source rebuilds only its library.  A build runs at
first use — never at import, so the CPU tests import this module on
machines without ``nvcc`` — into ``dbeel_tpu_torch/build/`` (listed in
``.gitignore``), under a name carrying the source's hash so a stale
library is never loaded.  An flock per source serialises concurrent
builders.

Every entry returns ``cudaGetLastError()``; ``check`` raises on non-zero.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = {
    name: os.path.join(_PKG_DIR, "csrc", f"{name}.cu")
    for name in ("bitonic", "merge_path", "query", "dist")
}
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

# Kernel launches per wrapper since the last reset_launches(): each
# wrapper adds one where it launches its kernel, and nowhere else.
# Wrappers launch from several threads (flush, compaction and scan
# executors), so counts are taken under a lock.
launches: Dict[str, int] = {
    name: 0
    for name in (
        "K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8a", "K8b", "K8c",
        "K8d", "K9b",
    )
}
_launches_lock = threading.Lock()


def reset_launches() -> None:
    with _launches_lock:
        for name in launches:
            launches[name] = 0


def count(name: str) -> None:
    with _launches_lock:
        launches[name] += 1


# Facts of each build that ran in this process, by source name
# (chip_smoke.py prints them); a cached library adds nothing.
build_info: Dict[str, dict] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> str:
    with open(SOURCES[name], "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libdbeel_{name}-{digest}.so")


def build(name: str) -> str:
    """Compile source ``name`` if it has no library yet; returns the
    library path.  A build that runs records its seconds, command and
    ``-Xptxas -v`` report (registers, shared memory and spills of each
    kernel) in ``build_info[name]``."""
    import fcntl

    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f".{name}.lock"), "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out
        tmp = f"{out}.tmp.{os.getpid()}"
        cmd = [
            nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
            SOURCES[name],
        ]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr}"
            )
        os.replace(tmp, out)
        build_info[name] = dict(
            seconds=time.perf_counter() - t0,
            command=" ".join(cmd),
            ptxas=proc.stderr,
        )
    return out


def _load(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    with _lock:
        handle = _libs.get(name)
        if handle is None:
            handle = ctypes.CDLL(build(name))
            bind(handle)
            _libs[name] = handle
        return handle


def _bind_bitonic(handle: ctypes.CDLL) -> None:
    vp, u32 = ctypes.c_void_p, ctypes.c_uint32
    handle.dbeel_bitonic_perm.argtypes = [
        vp, u32, u32, vp, vp, vp, vp,
    ]
    handle.dbeel_bitonic_merge_rows.argtypes = [
        vp, u32, u32, vp, vp, vp, vp,
    ]
    handle.dbeel_bitonic_sort_dedup_cols.argtypes = [vp, u32, vp, vp, vp, vp]
    for fn in (
        handle.dbeel_bitonic_perm,
        handle.dbeel_bitonic_merge_rows,
        handle.dbeel_bitonic_sort_dedup_cols,
    ):
        fn.restype = ctypes.c_int


def _bind_merge_path(handle: ctypes.CDLL) -> None:
    vp, u32 = ctypes.c_void_p, ctypes.c_uint32
    for fn in (
        handle.dbeel_merge_path_prefix32_packed,
        handle.dbeel_merge_path_prefix64_packed,
        handle.dbeel_merge_path_prefix_top,
    ):
        fn.argtypes = [vp, vp, u32, u32, u32, u32, vp, vp, vp]
        fn.restype = ctypes.c_int


def _bind_query(handle: ctypes.CDLL) -> None:
    vp, i32, i64, f64 = (
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double,
    )
    handle.dbeel_query_cmp_f64.argtypes = [vp, vp, i64, f64, i32, vp, vp]
    handle.dbeel_query_range_f64.argtypes = [
        vp, vp, i64, f64, f64, i32, i32, vp, vp,
    ]
    handle.dbeel_query_sum_f64.argtypes = [vp, vp, i64, vp, vp, vp]
    handle.dbeel_query_min_max_f64.argtypes = [vp, vp, i64, vp, vp, vp]
    for fn in (
        handle.dbeel_query_sum_scratch,
        handle.dbeel_query_min_max_scratch,
    ):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    for fn in (
        handle.dbeel_query_cmp_f64,
        handle.dbeel_query_range_f64,
        handle.dbeel_query_sum_f64,
        handle.dbeel_query_min_max_f64,
    ):
        fn.restype = ctypes.c_int


def _bind_dist(handle: ctypes.CDLL) -> None:
    vp, u32 = ctypes.c_void_p, ctypes.c_uint32
    handle.dbeel_dist_bucket_scatter.argtypes = [
        vp, u32, vp, u32, u32, vp, vp, vp, vp,
    ]
    handle.dbeel_dist_bucket_scatter.restype = ctypes.c_int


def lib() -> ctypes.CDLL:
    """The merge networks' library (``csrc/bitonic.cu``)."""
    return _load("bitonic", _bind_bitonic)


def merge_path_lib() -> ctypes.CDLL:
    """The merge-path merges' library (``csrc/merge_path.cu``)."""
    return _load("merge_path", _bind_merge_path)


def dist_lib() -> ctypes.CDLL:
    """The sample sort's library (``csrc/dist.cu``)."""
    return _load("dist", _bind_dist)


def query_lib() -> ctypes.CDLL:
    """The filter kernels' library (``csrc/query.cu``)."""
    return _load("query", _bind_query)


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def resolve_device(device=None):
    """The ``torch.device`` a device entry point runs on: ``cuda``
    unless the caller names another.  ``cpu`` selects the kernels'
    plain PyTorch versions; ``cuda`` without a card raises — there is
    no silent fallback to the host."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run "
            "the kernels' plain PyTorch versions"
        )
    return dev
