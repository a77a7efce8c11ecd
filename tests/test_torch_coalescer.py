"""dbeel_tpu_torch's compaction coalescer (K6, server/coalescer.py) and
compaction decision (server/tasks.py) against dbeel_tpu's.

The same seeded numpy inputs go through the JAX batch kernel (on the
CPU backend) and the port on ``cpu`` tensors (K6's plain PyTorch
version): outputs bit-equal with ragged counts, empty runs, one job and
all-0xFF prefixes, and the shapes the merge-path kernel meets in a
batch (out_rows off the tile, out_rows 0, K of 1 and 2, runs shorter
than a tile, a job with no rows).  ``pack_jobs`` stages real compaction
jobs as the merge path needs them: every run sorted on its two prefix
words, every row past its count SENTINEL in both.  Concurrent trees on
one coalescer meet in one launch and write files SHA-256-identical to
dbeel_tpu's coalesced trees and to the heap merge.  The ``cuda`` cases
hold the CUDA kernel against its plain version on a card and skip
without one.
"""

import asyncio
import hashlib
import os
import random

import numpy as np
import pytest
import torch

from dbeel_tpu.ops import bitonic as jb
from dbeel_tpu.server import coalescer as jco
from dbeel_tpu.storage import LSMTree as JTree
from dbeel_tpu.storage import columnar as jcol
from dbeel_tpu.storage.sstable import SSTable as JSSTable
from dbeel_tpu_torch.ops import bitonic as tb
from dbeel_tpu_torch.server import coalescer as tco
from dbeel_tpu_torch.server import tasks as ttasks
from dbeel_tpu_torch.storage import LSMTree as TTree
from dbeel_tpu_torch.storage import columnar as tcol
from dbeel_tpu_torch.storage.compaction import get_strategy as tget
from dbeel_tpu_torch.storage.entry import file_name
from dbeel_tpu_torch.storage.entry_writer import EntryWriter
from dbeel_tpu_torch.storage.sstable import SSTable as TSSTable
from dbeel_tpu_torch.utils import msgpack_codec

SENT = 0xFFFFFFFF


def _batch(rng, j, k, p, hi, kind="rand", salt=0.1):
    """(J, K, P, 2) sentinel-padded sorted prefix runs and their counts:
    "rand" ragged with one empty run, "zero_job" also job J // 2 empty,
    "one_run" every row in run 1 of each job; ``salt``, the share of
    valid rows whose words are 0xFFFFFFFF."""
    if kind == "one_run":
        counts = np.zeros((j, k), dtype=np.uint32)
        counts[:, min(1, k - 1)] = p
    else:
        counts = rng.integers(0, p + 1, size=(j, k)).astype(np.uint32)
        counts[0, 0] = 0
        counts[-1, -1] = p
        if kind == "zero_job":
            counts[j // 2] = 0
    pre = np.full((j, k, p, 2), SENT, dtype=np.uint32)
    for jj in range(j):
        for r in range(k):
            c = int(counts[jj, r])
            v = rng.integers(0, hi, size=(c, 2), dtype=np.uint64)
            v[rng.random(c) < salt] = SENT
            pre[jj, r, :c] = v[np.lexsort(v.T[::-1])] if c else v
    return pre, counts


@pytest.mark.parametrize(
    "j,k,p,out_rows",
    [(1, 1, 8, 8), (1, 4, 16, 64), (3, 4, 32, 100), (2, 8, 64, 0),
     (4, 2, 128, 256), (8, 4, 256, 1024)],
)
def test_prefix_batch_bit_equal(j, k, p, out_rows):
    rng = np.random.default_rng(j * 1000 + k * p)
    pre, counts = _batch(rng, j, k, p, 3)
    want = np.asarray(jb.merge_runs_prefix_batch_kernel(pre, counts, out_rows))
    got = tb.to_numpy(tb.merge_runs_prefix_batch_kernel(
        tb.to_tensor(pre, "cpu"), tb.to_tensor(counts, "cpu"), out_rows))
    assert got.shape == want.shape == (j, out_rows)
    np.testing.assert_array_equal(got, want)


def test_prefix_batch_all_ff_prefixes():
    """Valid rows whose prefix is all 0xFF tie with the padding on the
    prefix words; the index column still orders them first."""
    pre = np.full((2, 2, 16, 2), SENT, dtype=np.uint32)
    counts = np.array([[16, 5], [0, 16]], dtype=np.uint32)
    want = np.asarray(jb.merge_runs_prefix_batch_kernel(pre, counts, 32))
    got = tb.to_numpy(tb.merge_runs_prefix_batch_kernel(
        tb.to_tensor(pre, "cpu"), tb.to_tensor(counts, "cpu"), 32))
    np.testing.assert_array_equal(got, want)


# K6 on the merge path: the kTop epilogue over J > 1 jobs at the shapes
# that stress it.  (name, J, K, P, out_rows, counts, salt): counts
# "rand" ragged, "zero_job" one job with no rows, "one_run" every row in
# run 1 of each job; salt, the share of valid rows whose prefix is
# 0xFFFFFFFF in both words (tied with the padding on the key).
K6_EDGES = [
    ("out_rows_off_tile", 2, 4, 2048, 5000, "rand", 0.1),
    ("out_rows_0", 3, 4, 64, 0, "rand", 0.1),
    ("k1", 4, 1, 64, 40, "rand", 0.1),
    ("k2_no_work_half", 3, 2, 128, 256, "rand", 0.1),
    ("p_below_tile", 5, 8, 8, 50, "rand", 0.1),
    ("zero_job", 4, 4, 32, 100, "zero_job", 0.1),
    ("one_run", 3, 4, 64, 256, "one_run", 0.1),
    ("all_ff_prefixes", 3, 4, 256, 1000, "rand", 0.5),
]


@pytest.mark.parametrize("case", K6_EDGES, ids=[c[0] for c in K6_EDGES])
def test_prefix_batch_merge_path_edges_equal_reference(case):
    """The port's K6 (its plain version here) equals dbeel_tpu's K6 on
    JAX-CPU at every shape of the merge path's batch edge list."""
    _, j, k, p, out_rows, kind, salt = case
    rng = np.random.default_rng(j * 7919 + k * p + out_rows)
    pre, counts = _batch(rng, j, k, p, 3, kind, salt)
    want = np.asarray(jb.merge_runs_prefix_batch_kernel(pre, counts, out_rows))
    got = tb.to_numpy(tb.merge_runs_prefix_batch_kernel(
        tb.to_tensor(pre, "cpu"), tb.to_tensor(counts, "cpu"), out_rows))
    assert got.shape == want.shape == (j, out_rows)
    np.testing.assert_array_equal(got, want)


def test_k6_wrapper_refuses_bad_operands():
    pre = torch.zeros((2, 4, 8, 2), dtype=torch.int32)
    cnt = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        tb.merge_runs_prefix_batch_kernel(pre, cnt, 33)
    with pytest.raises(ValueError):
        tb.merge_runs_prefix_batch_kernel(pre, cnt[:1], 8)
    with pytest.raises(ValueError):
        tb.merge_runs_prefix_batch_kernel(pre[:, :3], cnt[:, :3], 8)


def _stage_tables(d, base_idx, runs, per, seed):
    rng = random.Random(seed)
    for r in range(runs):
        w = EntryWriter(d, base_idx + 2 * r, None)
        for key in sorted({f"{base_idx}-{rng.randrange(10**6):06d}".encode()
                           for _ in range(per)}):
            w.write(key, b"v", rng.randrange(1, 10**9))
        w.close()
    return [base_idx + 2 * r for r in range(runs)]


def _stage_doc_tables(d, base_idx, runs, per, seed):
    """Like ``_stage_tables`` with msgpack documents for values: a
    ``score`` of every lane type (ints, floats, strings, bools), some
    documents without it, and tombstones."""
    rng = random.Random(seed)
    scores = [lambda: rng.randrange(-50, 50), lambda: rng.random() * 100,
              lambda: f"s{rng.randrange(99):02d}", lambda: True]
    for r in range(runs):
        w = EntryWriter(d, base_idx + 2 * r, None)
        for key in sorted({f"{base_idx}-{rng.randrange(400):06d}".encode()
                           for _ in range(per)}):
            roll = rng.random()
            doc = ({} if roll < 0.1 else
                   {"score": rng.choice(scores)(), "r": r})
            w.write(key, b"" if roll > 0.93 else msgpack_codec.packb(doc),
                    rng.randrange(1, 10**9))
        w.close()
    return [base_idx + 2 * r for r in range(runs)]


def _load(col_mod, sstable_cls, d, indices):
    tabs = [sstable_cls(d, i, None) for i in indices]
    cols = col_mod.load_columns(tabs)
    for t in tabs:
        t.close()
    return cols, (np.bincount(cols.src).tolist() if len(cols) else [])


def test_pack_jobs_equal_reference(tmp_dir):
    specs = [(0, 2, 40), (100, 3, 25), (200, 1, 7)]
    idx = [_stage_tables(tmp_dir, b, r, n, b + 1) for b, r, n in specs]
    want = jco.pack_jobs([(*_load(jcol, JSSTable, tmp_dir, i), None)
                          for i in idx])
    got = tco.pack_jobs([(*_load(tcol, TSSTable, tmp_dir, i), None)
                         for i in idx])
    for name in ("k", "p", "out_rows", "real_rows", "pad_frac"):
        assert getattr(got, name) == getattr(want, name), name
    np.testing.assert_array_equal(got.prefixes, want.prefixes)
    np.testing.assert_array_equal(got.counts, want.counts)
    for a, b in zip(got.bases, want.bases):
        np.testing.assert_array_equal(a, b)


# Compaction jobs as the coalescer meets them: (base index, runs, keys
# a run) per job; a job of 3 runs pads K = 4 with an empty run.
PACK_SPECS = [
    [(0, 2, 40), (100, 3, 25), (200, 1, 7)],
    [(0, 3, 60), (300, 3, 5)],
    [(0, 1, 1), (50, 4, 33), (90, 2, 17)],
]


def _packed(tmp_dir, specs):
    idx = [_stage_tables(tmp_dir, b, r, n, b + 1) for b, r, n in specs]
    return tco.pack_jobs([(*_load(tcol, TSSTable, tmp_dir, i), None)
                          for i in idx])


@pytest.mark.parametrize("spec", range(len(PACK_SPECS)))
def test_pack_jobs_meets_merge_path_precondition(tmp_dir, spec):
    """The merge path's precondition on real compaction jobs: every
    staged run non-decreasing on (k0, k1), every row past its count
    SENTINEL in both words — ragged counts, and K padded with empty
    runs."""
    specs = PACK_SPECS[spec]
    got = _packed(tmp_dir, specs)
    j, k, p, _ = got.prefixes.shape
    assert (j, k, p) == (len(specs), got.k, got.p)
    assert (got.counts == 0).any()  # K padded with empty runs
    assert len(set(got.counts[got.counts > 0].tolist())) > 1  # ragged
    for jj in range(j):
        assert int(got.counts[jj].sum()) > 0
        for r in range(k):
            c = int(got.counts[jj, r])
            run = got.prefixes[jj, r].astype(np.uint64)
            key = run[:c, 0] << np.uint64(32) | run[:c, 1]
            assert (key[1:] >= key[:-1]).all()
            assert (got.prefixes[jj, r, c:] == SENT).all()


async def _fill(tree, salt):
    for i in range(600):
        await tree.set_with_timestamp(
            f"{salt}-key{i % 250:05}".encode(), f"val{i}".encode(), 1000 + i
        )
        if i % 97 == 0:
            await tree.delete_with_timestamp(
                f"{salt}-key{(i * 7) % 250:05}".encode(), 1000 + i
            )
    await tree.flush()


def _digest(d):
    out = {}
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f), "rb") as fh:
            out[f] = hashlib.sha256(fh.read()).hexdigest()
    return out


async def _coalesced_trees(tree_cls, root, make_strategy, n=4):
    trees = []
    for t in range(n):
        tree = tree_cls.open_or_create(
            f"{root}/shard{t}", capacity=300, strategy=make_strategy()
        )
        await _fill(tree, f"s{t}")
        trees.append(tree)

    async def compact(tree):
        idx = [i for i, _ in tree.sstable_indices_and_sizes()]
        await tree.compact(idx, max(idx) + 1, keep_tombstones=False)

    await asyncio.gather(*[compact(t) for t in trees])
    gets = [{f"s{t}-key{i:05}".encode(): await tree.get(
        f"s{t}-key{i:05}".encode()) for i in range(250)}
        for t, tree in enumerate(trees)]
    for tree in trees:
        tree.close()
    return [_digest(f"{root}/shard{t}") for t in range(n)], gets


def test_concurrent_compactions_coalesce_identical_to_reference(tmp_dir):
    jc = jco.CompactionCoalescer(window_s=0.05)
    want, want_gets = asyncio.run(_coalesced_trees(
        JTree, f"{tmp_dir}/j", lambda: jco.CoalescedDeviceMergeStrategy(jc)))
    tc = tco.CompactionCoalescer(window_s=0.05, device="cpu")
    got, got_gets = asyncio.run(_coalesced_trees(
        TTree, f"{tmp_dir}/t", lambda: tco.CoalescedDeviceMergeStrategy(tc)))
    heap, _ = asyncio.run(_coalesced_trees(
        TTree, f"{tmp_dir}/h", lambda: tget("heap")))
    assert (tc.launches, tc.jobs_coalesced) == (1, 4) == (
        jc.launches, jc.jobs_coalesced)
    assert tc.stats()["last_batch_jobs"] == 4
    assert got == want == heap
    assert got_gets == want_gets


def test_failed_launch_raises_without_host_merge(tmp_dir, monkeypatch):
    """The one deliberate difference from dbeel_tpu: a failed K6 launch
    fails the compaction instead of merging on the host."""
    def boom(*args, **kwargs):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(tb, "merge_runs_prefix_batch_kernel", boom)

    async def main():
        tree = TTree.open_or_create(
            f"{tmp_dir}/f", capacity=300,
            strategy=tco.CoalescedDeviceMergeStrategy(
                tco.CompactionCoalescer(device="cpu")),
        )
        await _fill(tree, "f")
        idx = [i for i, _ in tree.sstable_indices_and_sizes()]
        with pytest.raises(RuntimeError, match="launch failed"):
            await tree.compact(idx, max(idx) + 1, keep_tombstones=False)
        assert [i for i, _ in tree.sstable_indices_and_sizes()] == idx
        tree.close()

    asyncio.run(main())


def test_get_strategy_coalesced_and_sync_merge(tmp_dir, monkeypatch):
    """``coalesced`` on the CPU takes the CPU's own default coalescer;
    its sync merge (recovery) equals the heap merge, and with index
    fields its ``merge_async`` writes dbeel_tpu's index run."""
    s = tget("coalesced", device="cpu")
    assert s.name == "coalesced" and s.device.type == "cpu"
    assert s.coalescer is tco.default_coalescer("cpu")
    assert tco.stats("cpu") == s.coalescer.stats()
    idx = _stage_tables(tmp_dir, 0, 3, 50, 9)
    out = {}
    for name, strat in (("coalesced", s), ("heap", tget("heap"))):
        srcs = [TSSTable(tmp_dir, i, None) for i in idx]
        strat.merge(srcs, tmp_dir, 11, None, False, 1)
        for t in srcs:
            t.close()
        out[name] = {f: h for f, h in _digest(tmp_dir).items()
                     if f.startswith(file_name(11, ""))}
        for f in out[name]:
            os.unlink(os.path.join(tmp_dir, f))
    assert out["coalesced"] == out["heap"] and out["heap"]
    # With index fields the coalesced merge also writes the output's
    # compact_fidx run, SHA-256-equal to dbeel_tpu's coalesced merge.
    doc_idx = _stage_doc_tables(tmp_dir, 200, 3, 80, 9)
    runs = []
    for strat, table_cls, oi in (
        (s, TSSTable, 211), (jco.CoalescedDeviceMergeStrategy(), JSSTable, 213),
    ):
        strat.index_fields = ["score"]
        srcs = [table_cls(tmp_dir, i, None) for i in doc_idx]
        asyncio.run(strat.merge_async(srcs, tmp_dir, oi, None, False, 1))
        for t in srcs:
            t.close()
        runs.append([
            hashlib.sha256(open(os.path.join(
                tmp_dir, file_name(oi, ext)), "rb").read()).hexdigest()
            for ext in ("compact_data", "compact_fidx", "compact_fidx_sums")
        ])
    assert runs[0] == runs[1]


class _FakeTree:
    def __init__(self, sizes):
        self.sizes = sizes
        self.calls = []

    def sstable_indices_and_sizes(self):
        return list(self.sizes)

    async def compact(self, indices, output_index, keep_tombstones):
        self.calls.append((list(indices), output_index, keep_tombstones))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("factor", [2, 3])
def test_compact_tree_picks_reference_indices(seed, factor):
    from dbeel_tpu.server import tasks as jtasks

    rng = random.Random(seed)
    sizes = [(2 * i + (1 if rng.random() < 0.2 else 0),
              rng.choice([1, 3, 5]) << rng.randrange(10, 30))
             for i in range(rng.randrange(2, 14))]
    want, got = _FakeTree(sizes), _FakeTree(sizes)
    asyncio.run(jtasks.compact_tree(want, factor))
    asyncio.run(ttasks.compact_tree(got, factor))
    assert got.calls == want.calls
    assert ttasks.MIN_COMPACTION_FACTOR == jtasks.MIN_COMPACTION_FACTOR


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


# The card's cases: random batches, then both edge lists — K6_EDGES at
# their own P and at P x 64 (runs of 512 to 131072 rows, many tiles a
# job; out_rows scaled with them), and the packed compaction jobs.
CUDA_K6_CASES = (
    [("rand", (1, 1, 8, 8)), ("rand", (3, 4, 32, 100)),
     ("rand", (2, 8, 64, 0)), ("rand", (8, 4, 4096, 16384))]
    + [("edge", (c, scale)) for c in K6_EDGES for scale in (1, 64)]
    + [("pack", spec) for spec in range(len(PACK_SPECS))]
)


def _cuda_case_id(kind, case):
    if kind == "edge":
        return f"edge-{case[0][0]}-x{case[1]}"
    return f"{kind}-{case}"


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kind,case", CUDA_K6_CASES,
    ids=[_cuda_case_id(*c) for c in CUDA_K6_CASES],
)
def test_cuda_prefix_batch_equals_plain(cuda_device, tmp_dir, kind, case):
    if kind == "rand":
        j, k, p, out_rows = case
        rng = np.random.default_rng(700 + j * k * p)
        pre, counts = _batch(rng, j, k, p, 1 << 12)
    elif kind == "edge":
        (_, j, k, p, out_rows, ck, salt), scale = case
        p, out_rows = p * scale, out_rows * scale
        rng = np.random.default_rng(j * 7919 + k * p + out_rows)
        pre, counts = _batch(rng, j, k, p, 1 << 12, ck, salt)
    else:
        batch = _packed(tmp_dir, PACK_SPECS[case])
        pre, counts, out_rows = batch.prefixes, batch.counts, batch.out_rows
    x = tb.to_tensor(pre, cuda_device)
    c = tb.to_tensor(counts, cuda_device)
    assert torch.equal(
        tb.merge_runs_prefix_batch_kernel(x, c, out_rows),
        tb.prefix_top_batch_plain(x, c, out_rows),
    )
    torch.cuda.synchronize()
