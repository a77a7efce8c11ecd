"""A frozen copy of the SSTable format, for the checks to read tables
with.

Data record: ``[u32 key_len][u32 value_len][i64 timestamp_ns][key]
[value]``; index record: ``[u64 offset][u32 key_size][u32 full_size]``;
bloom file: ``[u64 num_bits][u32 num_hashes][u32 0]`` and the bit
array, bit ``i`` at byte ``i >> 3``, bit ``i & 7``, with ``num_hashes``
bits a key at ``(h1 + i * h2) mod num_bits`` for two murmur3_32 seeds
(``h2`` made odd), sized for a false-positive rate of 1%.  File names
are the index zero-padded to 20 digits, a dot and the extension.
"""

from __future__ import annotations

import math
import struct

import numpy as np

HEADER = 16
INDEX_DTYPE = np.dtype([("offset", "<u8"), ("key_size", "<u4"),
                        ("full_size", "<u4")])
BLOOM_SEED1 = 0x9747B28C
BLOOM_SEED2 = 0x85EBCA6B
BLOOM_HEADER = struct.Struct("<QII")


def file_name(index: int, ext: str) -> str:
    return f"{index:020d}.{ext}"


def murmur3_32_fixed(keys: np.ndarray, seed: int) -> np.ndarray:
    """MurmurHash3 x86_32 of each row of ``keys`` (uint8, one key a
    row, all of one length)."""
    n, length = keys.shape
    c1, c2 = np.uint32(0xCC9E2D51), np.uint32(0x1B873593)
    h = np.full(n, seed, np.uint32)
    nblocks = length // 4
    blocks = np.ascontiguousarray(keys[:, :nblocks * 4]).view("<u4")

    def rotl(x, r):
        return (x << np.uint32(r)) | (x >> np.uint32(32 - r))

    with np.errstate(over="ignore"):
        for b in range(nblocks):
            k = blocks[:, b].astype(np.uint32) * c1
            k = rotl(k, 15) * c2
            h = rotl(h ^ k, 13) * np.uint32(5) + np.uint32(0xE6546B64)
        tail = keys[:, nblocks * 4:].astype(np.uint32)
        if tail.shape[1]:
            k = np.zeros(n, np.uint32)
            for i in range(tail.shape[1] - 1, -1, -1):
                k ^= tail[:, i] << np.uint32(8 * i)
            k = rotl(k * c1, 15) * c2
            h ^= k
        h ^= np.uint32(length)
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    return h


def bloom_shape(n_items: int, fp_rate: float = 0.01):
    n = max(1, n_items)
    m = int(-n * math.log(fp_rate) / (math.log(2) ** 2)) + 1
    k = max(1, round(m / n * math.log(2)))
    return max(64, m), max(1, k)


def bloom_bytes(keys: np.ndarray, fp_rate: float = 0.01) -> bytes:
    """The bloom file of a table holding ``keys`` (uint8 rows)."""
    num_bits, num_hashes = bloom_shape(keys.shape[0], fp_rate)
    bits = np.zeros((num_bits + 7) // 8, np.uint8)
    h1 = murmur3_32_fixed(keys, BLOOM_SEED1).astype(np.uint64)
    h2 = (murmur3_32_fixed(keys, BLOOM_SEED2) | np.uint32(1)).astype(
        np.uint64)
    for i in range(num_hashes):
        idx = (h1 + np.uint64(i) * h2) % np.uint64(num_bits)
        np.bitwise_or.at(bits, (idx >> np.uint64(3)).astype(np.int64),
                         (np.uint8(1) << (idx & np.uint64(7)).astype(
                             np.uint8)))
    return BLOOM_HEADER.pack(num_bits, num_hashes, 0) + bits.tobytes()


def records_bytes(keys: np.ndarray, values: np.ndarray,
                  ts: np.ndarray) -> np.ndarray:
    """Data records of fixed-width ``keys`` and ``values`` (uint8
    rows) with timestamps ``ts``: one record a row."""
    n = keys.shape[0]
    out = np.zeros((n, HEADER + keys.shape[1] + values.shape[1]), np.uint8)
    hdr = out[:, :8].view("<u4")
    hdr[:, 0] = keys.shape[1]
    hdr[:, 1] = values.shape[1]
    out[:, 8:16] = np.asarray(ts, "<i8").view(np.uint8).reshape(n, 8)
    out[:, 16:16 + keys.shape[1]] = keys
    out[:, 16 + keys.shape[1]:] = values
    return out


def index_bytes(key_size: int, full_size: int, n: int) -> bytes:
    idx = np.zeros(n, INDEX_DTYPE)
    idx["offset"] = np.arange(n, dtype=np.uint64) * np.uint64(full_size)
    idx["key_size"] = key_size
    idx["full_size"] = full_size
    return idx.tobytes()
