"""dbeel_tpu_torch's scan and query path against dbeel_tpu's.

The same seeded ops (deterministic timestamps, the adversarial document
mix of tests/test_scan_plane.py plus NaN, -0.0, inf and subnormal
values) build one tree in each package; ``scan_page``, ``iter`` and
``scan_filter_page`` (drop and mark modes, with and without aggregates)
must then agree exactly: entries, ``more``, covers, scanned rows and
bytes, and aggregate partials.  The port runs with ``device="cpu"``, so
every numeric leaf of at least ``MIN_DEVICE_ROWS`` rows runs the K8
kernels' plain versions and reports ``eval_path == "device"``, where
dbeel_tpu — its jit gate closed on the CPU — reports ``"numpy"``.
"""

import asyncio
import random

import msgpack
import pytest
import torch

import dbeel_tpu.ops.query_kernels as jqk
from dbeel_tpu import query as JQ
from dbeel_tpu.storage import LSMTree as JTree
from dbeel_tpu_torch import query as TQ
from dbeel_tpu_torch.errors import CorruptedFile
from dbeel_tpu_torch.ops import query_kernels as tqk
from dbeel_tpu_torch.storage import LSMTree as TTree
from dbeel_tpu_torch.storage import scan_stage as tss
from dbeel_tpu_torch.storage.compaction import get_strategy as tget

OPS = ["==", "!=", "<", "<=", ">", ">="]


def _doc(rng, i):
    roll = rng.random()
    if roll < 0.05:
        return i  # not a map: matches no field leaf
    doc = {}
    if rng.random() < 0.9:
        doc["n"] = rng.choice([
            rng.randrange(-50, 50), float(rng.randrange(-500, 500)) / 7.0,
            (1 << 54) + rng.randrange(100), -((1 << 55) + rng.randrange(100)),
            True, float("nan"), -0.0, float("inf"), 5e-324, 0.0,
        ])
    if rng.random() < 0.85:
        doc["s"] = rng.choice(["apple", "banana", "cherry" * 2,
                               b"raw\x00middle", b"trailing\x00",
                               b"x" * 300, ""])
    if rng.random() < 0.3:
        doc["weird"] = [1, 2, 3]
    doc["i"] = i
    return doc


def _ops(seed, n):
    """(key, value or None for a delete, ts): n docs, then overwrites
    of a slice and a few deletes at newer timestamps."""
    rng = random.Random(seed)
    ops = [(msgpack.packb(f"k{i:05d}"), msgpack.packb(_doc(rng, i)),
            1000 + i) for i in range(n)]
    ops += [(msgpack.packb(f"k{i:05d}"), msgpack.packb(_doc(rng, -i)),
             10**6 + i) for i in range(n // 5, n // 5 + n // 8)]
    ops += [(msgpack.packb(f"k{i:05d}"), None, 10**7 + i)
            for i in (3, n // 4, n // 2, n - 1)]
    return ops


async def _tree(cls, d, ops, **kw):
    """Most ops flushed into tables, the last ones left in the memtable."""
    tree = cls.open_or_create(d, capacity=1 << 20, **kw)
    cut = len(ops) - len(ops) // 10
    for i, (k, v, ts) in enumerate(ops):
        if v is None:
            await tree.delete_with_timestamp(k, ts)
        else:
            await tree.set_with_timestamp(k, v, ts)
        if i == cut:
            await tree.flush()
    return tree


async def _pair(tmp_dir, ops):
    j = await _tree(JTree, f"{tmp_dir}/j", ops)
    t = await _tree(TTree, f"{tmp_dir}/t", ops, strategy=tget("heap"),
                    device="cpu")
    return j, t


def _where(rng, n):
    def leaf():
        field = rng.choice(["$key", "n", "n", "s", "i", "missing"])
        kind = rng.choice(["cmp", "cmp", "prefix", "range"])
        if field == "$key":
            a, b = sorted(msgpack.packb(f"k{rng.randrange(n):05d}")
                          for _ in range(2))
            return {"cmp": ["cmp", field, rng.choice(OPS), a],
                    "prefix": ["prefix", field, a[:rng.randrange(1, 6)]],
                    "range": ["range", field, a, b]}[kind]
        if kind == "cmp":
            return ["cmp", field, rng.choice(OPS), rng.choice([
                rng.randrange(-60, 60), float(rng.randrange(-70, 70)) / 3.0,
                0.0, -0.0, float("inf"), 5e-324, (1 << 54) + 5, "banana",
                b"raw\x00middle", b"trailing\x00", "y" * 280,
                rng.randrange(n)])]
        if kind == "prefix":
            return ["prefix", field, rng.choice(
                [b"app", b"che", b"raw", b"trailing\x00", b""])]
        if rng.random() < 0.6:
            lo, hi = sorted([rng.randrange(-60, n), rng.randrange(-60, n)])
            lo, hi = rng.choice([(lo, hi), (None, hi), (lo, None),
                                 (float(lo), 1 << 60)])
            return ["range", field, lo, hi]
        return ["range", field, b"a", rng.choice([b"cherry", b"z"])]

    def tree(depth):
        if depth == 0 or rng.random() < 0.45:
            return leaf()
        return [rng.choice(["and", "or"]),
                *[tree(depth - 1) for _ in range(rng.randrange(1, 4))]]

    return tree(2)


def _runs_k8(where):
    """Does the spec hold a numeric field leaf the filter kernels take
    (a float64-exact numeric operand)?"""
    if where is None:
        return False
    if where[0] in ("and", "or"):
        return any(_runs_k8(c) for c in where[1:])
    if where[1] == TQ.KEY_FIELD:
        return False
    big = lambda x: isinstance(x, int) and abs(x) > 1 << 53  # noqa: E731
    if where[0] == "cmp":
        return isinstance(where[3], (int, float)) and not big(where[3])
    if where[0] == "range":
        lo, hi = where[2], where[3]
        num = isinstance(lo, (int, float)) or isinstance(hi, (int, float))
        return num and not big(lo) and not big(hi)
    return False


async def _filter_pages(tree, where, agg, mode, limit, max_bytes,
                        with_values=True, start=0, end=0, prefix=None):
    pages, sa = [], None
    while True:
        page = await tree.scan_filter_page(
            start, end, sa, prefix, limit, max_bytes, with_values,
            where, agg, mode,
        )
        pages.append(page)
        if not page[1]:
            return pages
        sa = page[2]


def _same_pages(jp, tp, where):
    """Everything equal but eval_path, which the port reports as
    "device" where dbeel_tpu reports "numpy" for a spec that reached
    a filter kernel."""
    assert len(jp) == len(tp)
    for a, b in zip(jp, tp):
        assert repr(a[:6]) == repr(b[:6])
        if a[6] == "numpy" and _runs_k8(where):
            assert b[6] == "device"
        else:
            assert a[6] == b[6]


@pytest.fixture
def low_threshold(monkeypatch):
    """Stages of a few hundred rows reach the filter kernels in both
    packages (dbeel_tpu's gate stays closed: its numpy lane serves)."""
    monkeypatch.setattr(tqk, "MIN_DEVICE_ROWS", 16)
    monkeypatch.setattr(jqk, "MIN_DEVICE_ROWS", 16)


@pytest.mark.parametrize("seed", [1307, 11, 2024])
def test_scan_filter_pages_equal_reference(tmp_dir, low_threshold, seed):
    async def main():
        n = 900
        j, t = await _pair(tmp_dir, _ops(seed, n))
        rng = random.Random(seed)
        saw_device = False
        for trial in range(14):
            where = _where(rng, n)
            jw, tw = JQ.validate_where(where), TQ.validate_where(where)
            agg = None
            if trial % 3 == 2:
                raw = {"op": rng.choice(list(JQ.AGG_OPS)), "field": "n",
                       "group": rng.choice([0, 0, 4])}
                agg = (JQ.validate_agg(raw), TQ.validate_agg(raw))
            mode = "drop" if trial % 2 == 0 or agg else "mark"
            limit = rng.choice([64, 256, 10**6])
            max_bytes = rng.choice([2048, 1 << 20])
            jp = await _filter_pages(j, jw, agg and agg[0], mode, limit,
                                     max_bytes)
            tp = await _filter_pages(t, tw, agg and agg[1], mode, limit,
                                     max_bytes)
            _same_pages(jp, tp, tw)
            saw_device |= tp[0][6] == "device"
            if agg is not None:
                js, ts = JQ.AggState(agg[0]), TQ.AggState(agg[1])
                for a, b in zip(jp, tp):
                    js.fold_partial(a[5])
                    ts.fold_partial(b[5])
                assert repr(js.result()) == repr(ts.result())
        assert saw_device
        # Keys-only drop pages and an arc/prefix window.
        where = ["range", "n", -10, 30]
        for kw in (dict(with_values=False),
                   dict(start=123, end=2**31 + 7),
                   dict(prefix=msgpack.packb("k00110")[:5])):
            _same_pages(
                await _filter_pages(j, where, None, "drop", 50, 4096, **kw),
                await _filter_pages(t, where, None, "drop", 50, 4096, **kw),
                where,
            )
        j.close()
        t.close()

    asyncio.run(main())


def test_scan_pages_and_iter_equal_reference(tmp_dir):
    async def main():
        ops = _ops(5, 700)
        j, t = await _pair(tmp_dir, ops)
        got = [e async for e in t.iter()]
        assert got == [e async for e in j.iter()]
        assert {e[0] for e in got} == {k for k, _, _ in ops}

        async def pages(tree, **kw):
            out, sa = [], None
            while True:
                es, more = await tree.scan_page(start_after=sa, **kw)
                out.append((es, more))
                if not more or not es:
                    return out
                sa = es[-1][0]

        for case in (
            dict(start=0, end=0, prefix=None, limit=64, max_bytes=4096,
                 with_values=True),
            dict(start=123, end=2**31 + 7, prefix=None, limit=50,
                 max_bytes=2048, with_values=True),
            dict(start=0, end=0, prefix=msgpack.packb("k00110")[:5],
                 limit=1000, max_bytes=1 << 20, with_values=False),
            dict(start=2**32 - 5, end=7, prefix=None, limit=3,
                 max_bytes=1, with_values=False),
        ):
            assert await pages(t, **case) == await pages(j, **case), case
        assert t._scan_stage is not None
        j.close()
        t.close()

    asyncio.run(main())


def test_fallback_pages_equal_staged_and_reference(tmp_dir, monkeypatch,
                                                   low_threshold):
    """The golden per-entry pages (guard tripped) equal the staged ones
    and dbeel_tpu's golden pages."""
    import dbeel_tpu.storage.scan_stage as jss

    async def main():
        j, t = await _pair(tmp_dir, _ops(9, 600))
        specs = [(["cmp", "n", "<", 3], None, "drop"),
                 (["or", ["cmp", "s", ">=", "b"], ["range", "n", -5, 5]],
                  None, "mark"),
                 (["cmp", "i", ">=", 100],
                  {"op": "sum", "field": "n", "group": 4}, "drop")]
        staged = [await _filter_pages(t, w, a, m, 64, 4096)
                  for w, a, m in specs]
        staged_scan = await t.scan_page(0, 0, None, None, 10**6, 1 << 22,
                                        True)
        monkeypatch.setattr(tss, "MIN_VECTORIZED_ENTRIES", 10**9)
        monkeypatch.setattr(jss, "MIN_VECTORIZED_ENTRIES", 10**9)
        t._drop_scan_stage()
        assert await t.scan_page(0, 0, None, None, 10**6, 1 << 22,
                                 True) == staged_scan
        for (w, a, m), st in zip(specs, staged):
            golden = await _filter_pages(t, w, a, m, 64, 4096)
            ref = await _filter_pages(j, w, a, m, 64, 4096)
            assert repr(golden) == repr(ref)
            assert {p[6] for p in golden} == {"golden"}
            assert [p[:5] for p in golden] == [p[:5] for p in st]
            if a is not None:
                gs, ss = TQ.AggState(a), TQ.AggState(a)
                for p, q in zip(golden, st):
                    gs.fold_partial(p[5])
                    ss.fold_partial(q[5])
                assert repr(gs.result()) == repr(ss.result())
        j.close()
        t.close()

    asyncio.run(main())


def test_filter_at_the_real_device_threshold(tmp_dir):
    """Above MIN_DEVICE_ROWS with no threshold patched: the first page
    of each spec runs the filter kernels, later pages are cached."""
    async def main():
        n = tqk.MIN_DEVICE_ROWS + 300
        j, t = await _pair(tmp_dir, _ops(77, n))
        for where, agg, mode in (
            (["cmp", "n", "<=", 0.0], None, "drop"),
            (["range", "i", 100, 3000], None, "mark"),
            (["and", ["cmp", "n", ">", -1], ["cmp", "s", "<", "c"]],
             {"op": "max", "field": "n", "group": 0}, "drop"),
        ):
            jp = await _filter_pages(j, where, agg, mode, 512, 1 << 15)
            tp = await _filter_pages(t, where, agg, mode, 512, 1 << 15)
            _same_pages(jp, tp, where)
            assert [p[6] for p in tp] == ["device"] + ["cached"] * (
                len(tp) - 1)
            assert sum(p[3] for p in tp) == t._scan_stage.n
        j.close()
        t.close()

    asyncio.run(main())


def test_filter_needs_a_card_or_cpu(tmp_dir, monkeypatch):
    """device=None without a card: scan_filter_page raises once a
    numeric leaf reaches the kernels (>= MIN_DEVICE_ROWS rows) — no
    numpy fallback; smaller stages and key/byte leaves stay on numpy."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    async def main():
        ops = _ops(3, tqk.MIN_DEVICE_ROWS + 10)
        t = await _tree(TTree, f"{tmp_dir}/t", ops, strategy=tget("heap"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            await t.scan_filter_page(0, 0, None, None, 100, 1 << 20, True,
                                     ["cmp", "n", "<", 1], None, "drop")
        page = await t.scan_filter_page(0, 0, None, None, 100, 1 << 20,
                                        True, ["cmp", "s", "<", "c"], None,
                                        "drop")
        assert page[6] == "numpy"
        t.close()
        small = await _tree(TTree, f"{tmp_dir}/s", ops[:700],
                            strategy=tget("heap"))
        page = await small.scan_filter_page(0, 0, None, None, 100, 1 << 20,
                                            True, ["cmp", "n", "<", 1],
                                            None, "drop")
        assert page[6] == "numpy"
        small.close()

    asyncio.run(main())


def test_stage_dropped_on_flush_and_compaction(tmp_dir):
    async def main():
        t = await _tree(TTree, f"{tmp_dir}/t", _ops(4, 800),
                        strategy=tget("heap"), device="cpu")
        await t.scan_filter_page(0, 0, None, None, 10, 4096, True,
                                 ["cmp", "n", ">", 0], None, "drop")
        stage, lst = t._scan_stage, t._scan_stage_list
        assert stage is not None and lst.readers == 1
        # A write invalidates through the token.
        await t.set_with_timestamp(msgpack.packb("zz"), msgpack.packb(1), 5)
        await t.scan_page(0, 0, None, None, 10, 4096, True)
        assert t._scan_stage is not stage
        # A flush drops the cached stage and its reader ref eagerly...
        await t.flush()
        assert t._scan_stage is None and t._scan_stage_list is None
        await t.scan_page(0, 0, None, None, 10, 4096, True)
        assert t._scan_stage is not None
        # ...and so does compaction, whose reader drain would otherwise
        # wait for the next scan.
        idx = [i for i, _ in t.sstable_indices_and_sizes()]
        await asyncio.wait_for(
            t.compact(idx, max(idx) + 1, keep_tombstones=False), 60
        )
        assert t._scan_stage is None
        es, more = await t.scan_page(0, 0, None, None, 10**6, 1 << 22, False)
        assert (len(es), more) == (800 - 4 + 1, False)
        t.close()

    asyncio.run(main())


def test_value_column_build_crc_flip_quarantines(tmp_dir):
    async def main():
        t = TTree.open_or_create(f"{tmp_dir}/t", capacity=4096,
                                 strategy=tget("heap"), device="cpu")
        for i in range(800):
            await t.set_with_timestamp(
                msgpack.packb(f"k{i:05d}"),
                msgpack.packb({"blob": "x" * 64, "i": i}), 1000 + i)
        await t.flush()
        table = t._sstables.tables[0]
        off, ksz, _fsz = table._index_record(400)
        with open(table.data_path, "r+b") as f:
            f.seek(off + 16 + ksz + 8)
            b = f.read(1)
            f.seek(off + 16 + ksz + 8)
            f.write(bytes([b[0] ^ 0xFF]))
        with pytest.raises(CorruptedFile):
            await t.scan_filter_page(0, 0, None, None, 10**6, 1 << 22, True,
                                     ["cmp", "i", ">=", 0], None, "drop")
        assert t.durability["checksum_failures"] >= 1
        assert t.durability["quarantined_tables"] >= 1
        assert t.reads_suspect
        t.close()

    asyncio.run(main())


def test_vectorized_range_digests_equal_reference(tmp_dir):
    """The staging's source columns and batch hash, through the
    anti-entropy digests they were built for: equal per-bucket counts
    and digests over the same snapshot in both packages."""
    from dbeel_tpu.storage import range_digest as jrd
    from dbeel_tpu_torch.storage import range_digest as trd

    async def main():
        j, t = await _pair(tmp_dir, _ops(21, 3000))
        js, ts = j.scan_snapshot(), t.scan_snapshot()
        try:
            assert js.memtable_items == ts.memtable_items
            for start, end, buckets in ((0, 0, 16), (123, 2**31 + 7, 64),
                                        (2**32 - 99, 10**6, 1)):
                assert trd.vectorized_range_digests(
                    ts.memtable_items, ts.tables, start, end, buckets
                ) == jrd.vectorized_range_digests(
                    js.memtable_items, js.tables, start, end, buckets
                )
        finally:
            js.release()
            ts.release()
        j.close()
        t.close()

    asyncio.run(main())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_filter_pages_equal_plain(tmp_dir, cuda_device):
    """On the card (device None = cuda) the filtered pages equal the
    plain versions' (device "cpu") on the same tree, and the first page
    of each spec launches the filter kernels."""
    from dbeel_tpu_torch.ops import _cuda

    async def main():
        ops = _ops(8, tqk.MIN_DEVICE_ROWS + 500)
        card = await _tree(TTree, f"{tmp_dir}/g", ops, strategy=tget("heap"))
        host = await _tree(TTree, f"{tmp_dir}/c", ops, strategy=tget("heap"),
                           device="cpu")
        for where, agg, mode in (
            (["cmp", "n", "<", 0.5], None, "drop"),
            (["or", ["cmp", "n", "!=", 0.0], ["range", "i", 10, 900]],
             None, "mark"),
            (["range", "n", None, 3], {"op": "sum", "field": "n",
                                       "group": 0}, "drop"),
        ):
            before = dict(_cuda.launches)
            got = await _filter_pages(card, where, agg, mode, 512, 1 << 15)
            assert _cuda.launches["K8a"] + _cuda.launches["K8b"] > (
                before["K8a"] + before["K8b"])
            want = await _filter_pages(host, where, agg, mode, 512, 1 << 15)
            assert repr(got) == repr(want)
        card.close()
        host.close()

    asyncio.run(main())
