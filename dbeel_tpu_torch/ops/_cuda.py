"""Build and bind the CUDA kernels of ``csrc/bitonic.cu``.

Route (b) of a hand-written kernel: ``nvcc`` compiles the source into a
shared library with a plain C interface, loaded with ctypes.  The build
runs at first use — never at import, so the CPU tests import this module
on machines without ``nvcc`` — into ``dbeel_tpu_torch/build/`` (listed
in ``.gitignore``), under a name carrying the source's hash so a stale
library is never loaded.  An flock serialises concurrent builders.

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
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "bitonic.cu")
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

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
# Facts of the build that loaded the library (chip_smoke.py prints them).
build_info: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libdbeel_bitonic-{digest}.so")


def build() -> str:
    """Compile the kernels if this source has no library yet; returns
    the library path.  A build that runs records its seconds, command
    and ``-Xptxas -v`` report (registers, shared memory and spills of
    each kernel) in ``build_info``; a cached library leaves it empty."""
    import fcntl

    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out
        tmp = f"{out}.tmp.{os.getpid()}"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, SOURCE]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr}"
            )
        os.replace(tmp, out)
        build_info.update(
            seconds=time.perf_counter() - t0,
            command=" ".join(cmd),
            ptxas=proc.stderr,
        )
    return out


def lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        handle = ctypes.CDLL(build())
        vp, u32 = ctypes.c_void_p, ctypes.c_uint32
        handle.dbeel_bitonic_prefix32_packed.argtypes = [
            vp, vp, u32, u32, u32, u32, vp, vp, vp,
        ]
        handle.dbeel_bitonic_prefix64_packed.argtypes = [
            vp, vp, u32, u32, u32, u32, vp, vp, vp,
        ]
        handle.dbeel_bitonic_prefix_top.argtypes = [
            vp, vp, u32, u32, u32, vp, vp, vp,
        ]
        handle.dbeel_bitonic_perm.argtypes = [
            vp, u32, u32, vp, vp, vp, vp,
        ]
        handle.dbeel_bitonic_merge_rows.argtypes = [
            vp, u32, u32, vp, vp, vp, vp,
        ]
        handle.dbeel_bitonic_prefix_top_batch.argtypes = [
            vp, vp, u32, u32, u32, u32, vp, vp, vp,
        ]
        for fn in (
            handle.dbeel_bitonic_prefix32_packed,
            handle.dbeel_bitonic_prefix64_packed,
            handle.dbeel_bitonic_prefix_top,
            handle.dbeel_bitonic_perm,
            handle.dbeel_bitonic_merge_rows,
            handle.dbeel_bitonic_prefix_top_batch,
        ):
            fn.restype = ctypes.c_int
        _lib = handle
        return _lib


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
