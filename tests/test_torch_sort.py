"""dbeel_tpu_torch's flush sort (K5, ops/sort.py) and hash memtable
against dbeel_tpu's, and K7 (ops/merge.py) against K5, whose schedule
it runs on the card.

The same seeded numpy inputs go through the JAX functions (on the CPU
backend) and the port on ``cpu`` tensors, which run K5's plain PyTorch
version: the sorted stack and its same-key flags must be bit-equal —
rows tied on all 8 compared words, sentinel rows and one-row runs
(P = 1) included — and trees flushing through the hash memtable must
write SHA-256-identical files.  The ``cuda`` cases hold the CUDA kernel
against its plain version on a card and skip without one.
"""

import asyncio
import hashlib
import os
import random

import numpy as np
import pytest
import torch

from dbeel_tpu.ops import bitonic as jb
from dbeel_tpu.ops import sort as jsort
from dbeel_tpu.storage import LSMTree as JTree
from dbeel_tpu_torch.ops import bitonic as tb
from dbeel_tpu_torch.ops import merge as tmerge
from dbeel_tpu_torch.ops import sort as tsort
from dbeel_tpu_torch.storage import LSMTree as TTree
from dbeel_tpu_torch.storage.compaction import get_strategy as tget
from dbeel_tpu_torch.storage.memtable import HashMemtable

SENT = 0xFFFFFFFF


def _stack(rng, k, p, alphabet, short_runs=True):
    """(K, P, 9) sorted runs: cols 0-7 drawn from ``alphabet`` values
    (small = rows tied on all 8 compared words), col 8 a unique index,
    sentinel tails on some runs."""
    st = rng.integers(0, alphabet, size=(k, p, 9), dtype=np.uint64)
    st = st.astype(np.uint32)
    st[..., 8] = rng.permutation(k * p).reshape(k, p).astype(np.uint32)
    for r in range(k):
        st[r] = st[r][np.lexsort(st[r, :, :8].T[::-1])]
    if short_runs and p > 1:
        st[0, p // 2:] = SENT
        st[-1, 1:] = SENT
    return st


@pytest.mark.parametrize(
    "k,p,alphabet",
    [(1, 8, 2), (2, 8, 2), (8, 16, 2), (4, 64, 3), (16, 32, 1 << 32),
     (8, 1024, 2)],
)
def test_merge_rows_bit_equal(k, p, alphabet):
    st = _stack(np.random.default_rng(k * p + alphabet % 97), k, p, alphabet)
    want_out, want_same = jb.merge_runs_kernel(st)
    got_out, got_same = tb.merge_runs_kernel(tb.to_tensor(st, "cpu"))
    assert tuple(got_out.shape) == (k * p, 9)
    np.testing.assert_array_equal(tb.to_numpy(got_out), np.asarray(want_out))
    np.testing.assert_array_equal(got_same.numpy(), np.asarray(want_same))


@pytest.mark.parametrize("n", [1, 2, 8, 64, 1024, 4096])
def test_sort_stack_bit_equal_one_row_runs(n):
    """P = 1: every row its own run, full 8-word ties, a sentinel tail."""
    rng = np.random.default_rng(n)
    st = rng.integers(0, 2, size=(n, 9), dtype=np.uint64).astype(np.uint32)
    st[:, 8] = rng.permutation(n).astype(np.uint32)
    st[n - n // 8:] = SENT
    want_out, want_same = jb.sort_stack_kernel(st)
    got_out, got_same = tb.sort_stack_kernel(tb.to_tensor(st, "cpu"))
    np.testing.assert_array_equal(tb.to_numpy(got_out), np.asarray(want_out))
    np.testing.assert_array_equal(got_same.numpy(), np.asarray(want_same))


def test_k5_wrapper_refuses_bad_operands():
    with pytest.raises(ValueError):
        tb.merge_runs_kernel(torch.zeros((3, 8, 9), dtype=torch.int32))
    with pytest.raises(ValueError):
        tb.merge_runs_kernel(torch.zeros((2, 8, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        tb.sort_stack_kernel(torch.zeros((8, 9), dtype=torch.int64))


def _tie_stack(rng, k, p):
    """(K, P, 9) sorted runs tied on every compared word: cols 0-7 from
    {0, 1}, col 8 distinct, and a sentinel tail of an eighth of the rows
    (sentinel rows sort last, so each run stays sorted)."""
    n = k * p
    flat = rng.integers(0, 2, size=(n, 9), dtype=np.uint64).astype(np.uint32)
    flat[:, 8] = rng.permutation(n).astype(np.uint32)
    flat[n - n // 8:] = SENT
    st = flat.reshape(k, p, 9)
    if p > 1:  # a one-row run is sorted already
        for r in range(k):
            st[r] = st[r][np.lexsort(st[r, :, :8].T[::-1])]
    return st


# K5's tile on the card (kTile in csrc/bitonic.cu): N at half a
# tile (one launch), one tile, two (one level past the tile) and four;
# one-row runs (sort_stack_kernel) and K = 4 runs of N/4 rows (at 4
# tiles the first launch runs no level).
K5_TILE = 1024
K5_SIZES = [K5_TILE // 2, K5_TILE, 2 * K5_TILE, 4 * K5_TILE]


@pytest.mark.parametrize("p_kind", ["one_row_runs", "four_runs"])
@pytest.mark.parametrize("n", K5_SIZES)
def test_k5_plain_equals_jax_at_tile_sizes(n, p_kind):
    rng = np.random.default_rng(n + len(p_kind))
    k, p = (n, 1) if p_kind == "one_row_runs" else (4, n // 4)
    st = _tie_stack(rng, k, p)
    if p == 1:
        want_out, want_same = jb.sort_stack_kernel(st[:, 0])
        got_out, got_same = tb.sort_stack_kernel(tb.to_tensor(st[:, 0], "cpu"))
    else:
        want_out, want_same = jb.merge_runs_kernel(st)
        got_out, got_same = tb.merge_runs_kernel(tb.to_tensor(st, "cpu"))
    np.testing.assert_array_equal(tb.to_numpy(got_out), np.asarray(want_out))
    np.testing.assert_array_equal(got_same.numpy(), np.asarray(want_same))
    # The flags mark whole-row ties; the sentinel tail is never flagged.
    assert got_same.any() and not got_same[n - n // 8:].any()


def _k7_rows(rng, n):
    """(N, 9) rows for K7: cols 0-7 from {0, 1} (ties on all 8 key
    columns), col 8 distinct, and a sentinel tail of max(2, N/8) rows
    (K7's padding: every word 0xFFFFFFFF)."""
    rows = rng.integers(0, 2, size=(n, 9), dtype=np.uint64).astype(np.uint32)
    rows[:, 8] = rng.permutation(n).astype(np.uint32)
    rows[n - max(2, n // 8):] = SENT
    return rows


@pytest.mark.parametrize("n", [8, 1024, 2048, 1 << 13])
def test_k7_plain_is_k5_with_its_own_flags(n):
    """K7 runs K5's schedule with P = 1 (csrc/bitonic.cu k5_merge_rows):
    on the same rows, sort_dedup_plain's columns are merge_rows_plain's
    rows transposed, and its flags (_same_key_mask: words 0-4 equal to
    the previous row's, no sentinel check) are K5's except on an
    all-sentinel row after another, where K7 flags 1 and K5 0."""
    rows = _k7_rows(np.random.default_rng(700 + n), n)
    x = tb.to_tensor(rows, "cpu")
    k5_out, k5_same = tb.merge_rows_plain(x[:, None])
    k7_out, k7_same = tmerge.sort_dedup_plain(x.t().contiguous())
    assert torch.equal(k7_out, k5_out.t())
    sent = (k5_out == -1).all(dim=1)
    after = sent & torch.cat([torch.zeros(1, dtype=torch.bool), sent[:-1]])
    assert int(after.sum()) == max(2, n // 8) - 1
    assert not k5_same[after].any() and k7_same[after].all()
    assert torch.equal(k7_same, k5_same | after)
    assert k5_same.any()  # the ties are flagged by both


def _items(seed, n, long_share=0.2):
    """Unique keys: short ones, and long ones sharing 16-byte prefixes
    (prefix + length ties the device order cannot break)."""
    rng = random.Random(seed)
    keys = set()
    while len(keys) < n:
        if rng.random() < long_share:
            head = b"sharedprefix-%03d" % rng.randrange(4)
            keys.add(head + bytes(rng.randrange(60, 70)
                                  for _ in range(rng.randrange(0, 4))))
        else:
            keys.add(bytes(rng.randrange(256)
                           for _ in range(rng.randrange(1, 24))))
    items = [(k, (b"v%d" % i, i)) for i, k in enumerate(keys)]
    rng.shuffle(items)
    return items


@pytest.mark.parametrize("n", [1, 2, 100, 700])
def test_device_sort_equals_reference(n):
    items = _items(n, n)
    want = jsort._device_sort(list(items))
    assert tsort._device_sort(list(items), "cpu") == want
    assert want == sorted(items, key=lambda kv: kv[0])


@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_sort_items_around_threshold(monkeypatch, delta):
    """Both packages route below the threshold to the host sort and at
    or above it to the device sort; outputs equal either way."""
    threshold = 64
    monkeypatch.setattr(jsort, "DEVICE_THRESHOLD", threshold)
    monkeypatch.setattr(tsort, "DEVICE_THRESHOLD", threshold)
    calls = []
    real = tsort._device_sort
    monkeypatch.setattr(
        tsort, "_device_sort",
        lambda items, dev: calls.append(len(items)) or real(items, dev),
    )
    items = _items(7 + delta, threshold + delta)
    assert tsort.sort_items(list(items), "cpu") == jsort.sort_items(
        list(items)
    )
    assert calls == ([] if delta < 0 else [threshold + delta])


def test_sort_items_at_the_real_threshold():
    t = tsort.DEVICE_THRESHOLD
    assert t == jsort.DEVICE_THRESHOLD == 1 << 16
    items = _items(11, t, long_share=0.01)
    for n in (t - 1, t):
        assert tsort.sort_items(items[:n], "cpu") == jsort.sort_items(
            items[:n]
        )


def test_sort_items_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsort.sort_items([(b"a", (b"v", 1))])
    assert tsort.sort_items([(b"b", (b"", 1)), (b"a", (b"", 2))], "cpu")[
        0][0] == b"a"


def test_hash_memtable_caches_until_a_write():
    m = HashMemtable(16, device="cpu")
    m.set(b"b", b"1", 1)
    m.set(b"a", b"2", 2)
    first = m.sorted_items()
    assert [k for k, _ in first] == [b"a", b"b"]
    assert m.sorted_items() is first
    m.set_batch([(b"c", b"3", 3)])
    assert [k for k, _ in m.sorted_items()] == [b"a", b"b", b"c"]


def _digest(d):
    out = {}
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f), "rb") as fh:
            out[f] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _ops(seed, n=1500):
    """Seeded sets/overwrites/deletes, deterministic timestamps; keys
    share 8-byte prefixes and some run past 16 bytes sharing the
    first 16."""
    rng = random.Random(seed)
    keys = [b"user:%04d" % rng.randrange(500) for _ in range(n)]
    keys += [b"verylongsharedprefix-0123456789-"
             + bytes([rng.randrange(65, 70)]) * rng.randrange(1, 4)
             for _ in range(150)]
    rng.shuffle(keys)
    return [(k, None if rng.random() < 0.08 else b"v%d" % i, 5_000 + i)
            for i, k in enumerate(keys)]


async def _settle():
    others = [t for t in asyncio.all_tasks()
              if t is not asyncio.current_task()]
    await asyncio.gather(*others)


async def _flush_script(open_tree, d, ops):
    """Writes with capacity-triggered flushes, a close with WAL-resident
    entries, a reopen that replays the WAL, then a final flush."""
    tree = open_tree(d)
    half = len(ops) * 2 // 3
    for k, v, ts in ops[:half]:
        if v is None:
            await tree.delete_with_timestamp(k, ts)
        else:
            await tree.set_with_timestamp(k, v, ts)
    await _settle()
    tree.close()
    tree = open_tree(d)
    for k, v, ts in ops[half:]:
        if v is None:
            await tree.delete_with_timestamp(k, ts)
        else:
            await tree.set_with_timestamp(k, v, ts)
    await tree.flush()
    gets = {k: await tree.get(k) for k, _, _ in ops}
    await _settle()
    tree.close()
    return _digest(d), gets


def test_hash_tree_flushes_identical_to_reference_and_sorted(
    tmp_dir, monkeypatch
):
    """With both thresholds lowered, every flush of 64+ items runs the
    device sort (K5's plain version here, JAX-CPU there)."""
    monkeypatch.setattr(jsort, "DEVICE_THRESHOLD", 64)
    monkeypatch.setattr(tsort, "DEVICE_THRESHOLD", 64)
    calls = []
    real = tsort._device_sort
    monkeypatch.setattr(
        tsort, "_device_sort",
        lambda items, dev: calls.append(dev.type) or real(items, dev),
    )
    ops = _ops(5)
    kw = dict(capacity=200, bloom_min_size=2048)
    ref = asyncio.run(_flush_script(
        lambda d: JTree.open_or_create(d, memtable_kind="hash", **kw),
        f"{tmp_dir}/j", ops))
    port_hash = asyncio.run(_flush_script(
        lambda d: TTree.open_or_create(
            d, memtable_kind="hash", device="cpu", **kw),
        f"{tmp_dir}/h", ops))
    port_sorted = asyncio.run(_flush_script(
        lambda d: TTree.open_or_create(
            d, memtable_kind="sorted", strategy=tget("heap"), **kw),
        f"{tmp_dir}/s", ops))
    assert calls and set(calls) == {"cpu"}
    assert port_hash == ref
    assert port_sorted == ref
    oracle = {}
    for k, v, _ in ops:
        oracle[k] = v
    assert port_hash[1] == oracle


def test_memtable_kinds(tmp_dir, monkeypatch):
    tree = TTree.open_or_create(
        f"{tmp_dir}/h", memtable_kind="hash", device="cpu"
    )
    assert isinstance(tree._active, HashMemtable)
    assert tree._active.device.type == "cpu"
    assert tree.strategy.device.type == "cpu"
    tree.close()
    with pytest.raises(ValueError):
        TTree.open_or_create(f"{tmp_dir}/x", memtable_kind="btree")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TTree.open_or_create(
            f"{tmp_dir}/c", memtable_kind="hash", strategy=tget("heap")
        )


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 8, 1024, 4096, 1 << 17])
def test_cuda_sort_stack_equals_plain(cuda_device, n):
    rng = np.random.default_rng(900 + n)
    st = rng.integers(0, 2, size=(n, 9), dtype=np.uint64).astype(np.uint32)
    st[:, 8] = rng.permutation(n).astype(np.uint32)
    st[n - n // 8:] = SENT
    x = tb.to_tensor(st, cuda_device)
    want = tb.merge_rows_plain(x[:, None])
    for got, w in zip(tb.sort_stack_kernel(x), want):
        assert torch.equal(got, w)
    st = tb.to_tensor(_stack(rng, 8, 512, 2), cuda_device)
    for got, want in zip(tb.merge_runs_kernel(st), tb.merge_rows_plain(st)):
        assert torch.equal(got, want)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_sort_items_equals_host(cuda_device):
    items = _items(3, tsort.DEVICE_THRESHOLD + 5)
    before = tb.launches["K5"]
    assert tsort.sort_items(list(items)) == sorted(items, key=lambda kv: kv[0])
    assert tb.launches["K5"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n", [1, 2, 4, K5_TILE // 2, K5_TILE, 2 * K5_TILE, 1 << 17, 1 << 19,
          1 << 20],
)
def test_cuda_k5_schedule_equals_plain(cuda_device, n):
    """The grouped schedule (csrc/bitonic.cu k5_merge_rows) bit-equal
    to the network at every N from one row to the mesh's final sort:
    full 8-word ties, a sentinel tail.  Past N = tile^2/2 = 2^19 the
    last level runs its strides of a tile or more one launch each."""
    x = tb.to_tensor(_tie_stack(np.random.default_rng(n), n, 1)[:, 0],
                     cuda_device)
    before = tb.launches["K5"]
    got = tb.sort_stack_kernel(x)
    assert tb.launches["K5"] == before + 1
    for g, w in zip(got, tb.merge_rows_plain(x[:, None])):
        assert torch.equal(g, w)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("k,p", [(8, 1 << 14), (2, 1 << 16)])
def test_cuda_k5_long_runs_equal_plain(cuda_device, k, p):
    st = tb.to_tensor(_tie_stack(np.random.default_rng(k), k, p),
                      cuda_device)
    for g, w in zip(tb.merge_runs_kernel(st), tb.merge_rows_plain(st)):
        assert torch.equal(g, w)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 1024, 2048, 1 << 19, 1 << 20])
def test_cuda_k7_schedule_equals_plain(cuda_device, n):
    """K7 on K5's schedule, one call and one count, bit-equal to
    sort_dedup_plain: N of one tile's first launch alone (8, 1024), one
    level past the tile (2048), the main path's 2^19 and 2^20, whose
    last level runs its strides of a tile or more one launch each."""
    cols = tb.to_tensor(_k7_rows(np.random.default_rng(n), n).T.copy(),
                        cuda_device)
    before = tb.launches["K7"]
    got = tmerge.sort_dedup_kernel(cols)
    assert tb.launches["K7"] == before + 1
    for g, w in zip(got, tmerge.sort_dedup_plain(cols)):
        assert torch.equal(g, w)
    torch.cuda.synchronize()
