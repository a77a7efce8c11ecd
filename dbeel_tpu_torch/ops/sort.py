"""Flush sort — order a memtable's items for SSTable writing.

The HashMemtable (storage/memtable.py) skips per-insert ordering and
this module sorts the whole batch at flush time: "a single-run device
sort" in place of the reference's red-black-tree flush.

The device path stages 16-byte key-prefix columns and runs the bitonic
full sort (ops/bitonic.py sort_stack_kernel, K5); prefix ties are
refined on the host.  Below ``DEVICE_THRESHOLD`` items the host sort
wins outright (a device round trip costs more than sorting thousands of
keys in CPython), so small flushes stay host-side — the same routing as
dbeel_tpu/ops/sort.py, and the same output either way.

``device`` is ``cuda`` unless the caller names ``cpu``, which runs K5's
plain PyTorch version; without a card ``cuda`` raises.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

Item = Tuple[bytes, Tuple[bytes, int]]

# Below this many items a host sort beats the device round trip.
DEVICE_THRESHOLD = 1 << 16


def sort_items(items: List[Item], device=None) -> List[Item]:
    from ._cuda import resolve_device

    dev = resolve_device(device)
    if len(items) < DEVICE_THRESHOLD:
        return sorted(items, key=lambda kv: kv[0])
    return _device_sort(items, dev)


def _device_sort(items: List[Item], device=None) -> List[Item]:
    from ..storage import columnar
    from . import bitonic
    from ._cuda import resolve_device

    device = resolve_device(device)
    n = len(items)
    keys = [k for k, _ in items]
    # Stage 16B prefix words + index; a single unsorted "run".
    lens = np.fromiter(
        (len(k) for k in keys), dtype=np.uint32, count=n
    )
    width = columnar.KEY_PREFIX_BYTES
    mat = np.zeros((n, width), dtype=np.uint8)
    for i, k in enumerate(keys):
        kb = k[:width]
        mat[i, : len(kb)] = np.frombuffer(kb, dtype=np.uint8)
    words = (
        np.ascontiguousarray(mat)
        .view(np.dtype(">u4"))
        .astype(np.uint32)
        .reshape(n, 4)
    )
    p = 1
    while p < n:
        p <<= 1
    stack = np.full((p, bitonic.NUM_COLS), 0xFFFFFFFF, dtype=np.uint32)
    stack[:n, 0:4] = words
    stack[:n, 4] = lens
    stack[:n, 5] = 0  # ts/src irrelevant: keys are unique in a memtable
    stack[:n, 6] = 0
    stack[:n, 7] = 0
    stack[:n, 8] = np.arange(n, dtype=np.uint32)
    out, _same = bitonic.sort_stack_kernel(bitonic.to_tensor(stack, device))
    # A blocking device→host copy on the launching thread's stream: the
    # order is complete before any item is touched.
    order = bitonic.to_numpy(out[:n, 8].contiguous()).astype(np.int64)
    ordered = [items[i] for i in order]
    if int(lens.max()) <= columnar.KEY_PREFIX_BYTES:
        return ordered  # prefix+len fully determine the order
    # Host refinement: re-sort every run of equal 16B prefixes that
    # contains a long key (prefix+len ordering is not lexicographic
    # there — same rule as columnar.fixup_long_key_ties).
    result: List[Item] = []
    w = columnar.KEY_PREFIX_BYTES

    def padded(k: bytes) -> bytes:
        return k[:w].ljust(w, b"\x00")

    i = 0
    while i < len(ordered):
        j = i + 1
        prefix = padded(ordered[i][0])
        any_long = len(ordered[i][0]) > columnar.KEY_PREFIX_BYTES
        while j < len(ordered) and padded(ordered[j][0]) == prefix:
            any_long |= len(ordered[j][0]) > columnar.KEY_PREFIX_BYTES
            j += 1
        if j - i > 1 and any_long:
            result.extend(sorted(ordered[i:j], key=lambda kv: kv[0]))
        else:
            result.extend(ordered[i:j])
        i = j
    return result
