"""The serving data plane, the quorum fan-out engine, their bindings and
the LSMTree write-state listener of dbeel_tpu_torch against dbeel_tpu.

Both packages bind the same ``native/`` library.  Every comparison is
stated at its assert: the ctypes prototypes are equal, ``try_handle``
tuples are byte-equal (response bytes, keepalive, op, extra, the flush
tree by name; a punt falls on the same frame), the bytes a replica
receives are equal, and the listener's events are equal in order.  The
data plane stamps each write itself, so files it wrote are compared by
what they serve, never by hash."""

import asyncio
import os
import shutil
import socket
import struct
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from conftest import run

from dbeel_tpu.cluster import messages as jmsgs
from dbeel_tpu.cluster import native_fanout as jqf
from dbeel_tpu.server import dataplane as jdp
from dbeel_tpu.storage import LSMTree as JTree
from dbeel_tpu.storage import file_io as jfile_io
from dbeel_tpu.storage import native as jnative
from dbeel_tpu.storage.compaction import get_strategy as jget
from dbeel_tpu.utils.murmur import hash_bytes as jhash
from dbeel_tpu_torch.cluster import messages as tmsgs
from dbeel_tpu_torch.cluster import native_fanout as tqf
from dbeel_tpu_torch.server import dataplane as tdp
from dbeel_tpu_torch.storage import LSMTree as TTree
from dbeel_tpu_torch.storage import file_io as tfile_io
from dbeel_tpu_torch.storage import native as tnative
from dbeel_tpu_torch.storage.compaction import get_strategy as tget
from dbeel_tpu_torch.utils import msgpack_codec as codec
from dbeel_tpu_torch.utils.murmur import hash_bytes as thash

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {
    "ref": SimpleNamespace(
        dp=jdp, qf=jqf, msgs=jmsgs, file_io=jfile_io, hash=jhash,
        tree=lambda d, **kw: JTree.open_or_create(
            d, strategy=jget("cpu"), **kw),
        tree_cls=JTree, strategy=lambda: jget("cpu")),
    "port": SimpleNamespace(
        dp=tdp, qf=tqf, msgs=tmsgs, file_io=tfile_io, hash=thash,
        tree=lambda d, **kw: TTree.open_or_create(
            d, strategy=tget("cpu", device="cpu"), device="cpu", **kw),
        tree_cls=TTree, strategy=lambda: tget("cpu", device="cpu")),
}

# Every serving symbol the port binds (a static list: the prototypes
# table, not the library, decides it).
_SERVING = sorted(
    n for n in tnative._PROTOTYPES if n.startswith(("dbeel_dp_", "dbeel_qf_"))
)


@pytest.fixture(autouse=True)
def _native_library():
    if tnative.load() is None or not jnative.native_available():
        pytest.skip("native library cannot be built")


@pytest.fixture(scope="module")
def ref_bound():
    """The reference library object after the reference bound its
    serving prototypes: its loader binds all but ``dbeel_dp_set_multi``,
    which its DataPlane binds when ``DBEEL_DP_NO_MULTI`` is set."""
    lib = jnative._load()
    if lib is None:
        pytest.skip("native library cannot be built")
    old = os.environ.get("DBEEL_DP_NO_MULTI")
    os.environ["DBEEL_DP_NO_MULTI"] = "1"
    try:
        jdp.DataPlane(lib)
    finally:
        if old is None:
            del os.environ["DBEEL_DP_NO_MULTI"]
        else:
            os.environ["DBEEL_DP_NO_MULTI"] = old
    return lib


# ---------------------------------------------------------------------
# Bindings
# ---------------------------------------------------------------------


def test_port_binds_every_serving_symbol_the_reference_binds(ref_bound):
    """Equal sets: the serving symbols the reference looked up and
    declared are exactly the port's."""
    bound = {
        n for n in vars(ref_bound)
        if n.startswith(("dbeel_dp_", "dbeel_qf_"))
    }
    assert bound == set(_SERVING)


@pytest.mark.parametrize("symbol", _SERVING)
def test_serving_prototype_equals_reference(ref_bound, symbol):
    """Equal restype and argtypes (ctypes types compare by identity)."""
    restype, argtypes = tnative._PROTOTYPES[symbol]
    fn = getattr(ref_bound, symbol)
    assert restype is fn.restype or (restype is None and fn.restype is None)
    assert list(argtypes) == list(fn.argtypes)
    port_fn = getattr(tnative.load(), symbol)
    assert port_fn.restype is fn.restype
    assert list(port_fn.argtypes) == list(fn.argtypes)


def _subprocess(code, env_extra):
    env = dict(os.environ, PYTHONPATH=ROOT, **env_extra)
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=60,
    )


def test_native_so_override_loads_the_copy_without_rebuild(tmp_path):
    """DBEEL_NATIVE_SO at a copy of the built library: the port maps
    that copy, never runs make, and serves through it — even with the
    sources made newer than the copy."""
    copy = tmp_path / "libdbeel_copy.so"
    shutil.copy(tnative.DEFAULT_LIB_PATH, copy)
    os.utime(copy, (1, 1))  # older than every source
    code = r"""
import subprocess
from dbeel_tpu_torch.storage import native
def refuse(*a, **k):
    raise AssertionError("make was run for an overridden library")
native.subprocess.run = refuse
assert native.LIB_OVERRIDDEN and native.LIB_PATH.endswith("libdbeel_copy.so")
assert native.load_if_built() is not None
maps = open("/proc/self/maps").read()
assert native.LIB_PATH in maps, "the copy is not mapped"
from dbeel_tpu_torch.server.dataplane import create_dataplane
assert create_dataplane() is not None
print("ok")
"""
    out = _subprocess(code, {"DBEEL_NATIVE_SO": str(copy)})
    assert out.returncode == 0 and out.stdout.strip() == "ok", (
        out.stdout + out.stderr)


def test_native_so_override_that_does_not_load_raises(tmp_path):
    """A missing override raises in every call, in both packages' way
    (RuntimeError naming the variable), instead of degrading."""
    code = r"""
from dbeel_tpu_torch.storage import native
for _ in range(2):
    for fn in (native.load, native.load_if_built):
        try:
            fn()
        except RuntimeError as e:
            assert "DBEEL_NATIVE_SO" in str(e), e
        else:
            raise AssertionError("no error")
from dbeel_tpu_torch.server.dataplane import create_dataplane
assert create_dataplane() is None  # the constructor's log.exception path
print("ok")
"""
    out = _subprocess(code, {"DBEEL_NATIVE_SO": str(tmp_path / "none.so")})
    assert out.returncode == 0 and out.stdout.strip() == "ok", (
        out.stdout + out.stderr)


# ---------------------------------------------------------------------
# LSMTree write_state_listener
# ---------------------------------------------------------------------


def _listener_script(pkg, d):
    """open -> writes -> flush -> writes -> flush -> compact ->
    quarantine; the events the listener saw, each as (tables, flushing,
    active entries)."""
    m = PKGS[pkg]
    events = []
    rng = np.random.default_rng(3)
    keys = [b"key-%04d" % i for i in range(60)]

    async def main():
        tree = m.tree_cls(d, capacity=128, memtable_kind="arena",
                          strategy=m.strategy(),
                          **({"device": "cpu"} if pkg == "port" else {}))
        tree.write_state_listener = lambda t: events.append((
            tuple(x.index for x in t._sstables.tables),
            t._flushing is not None,
            len(t._active),
        ))
        tree._open()

        async def settle():
            for _ in range(10):
                await asyncio.sleep(0.01)

        for rnd in range(2):
            for i in range(40):
                k = keys[int(rng.integers(0, len(keys)))]
                await tree.set_with_timestamp(k, rng.bytes(9),
                                              1000 * rnd + i + 1)
            await tree.flush()
            await settle()
        tables = [i for i, _ in tree.sstable_indices_and_sizes()]
        await tree.compact(tables, max(tables) + 1, keep_tombstones=False)
        await settle()
        await tree.set_with_timestamp(b"late", b"v", 5000)
        await tree.flush()
        await settle()
        tree.quarantine_table(tree._sstables.tables[0], "listener test")
        await asyncio.gather(*tree._retire_tasks)
        await settle()
        tree.close()

    run(main(), timeout=30)
    return events


def test_write_state_listener_fires_like_reference(tmp_path):
    """Equal event lists: the same events in the same order."""
    ref = _listener_script("ref", str(tmp_path / "ref"))
    port = _listener_script("port", str(tmp_path / "port"))
    assert port == ref
    # open, 3 x (swap, commit, warm), compaction (swap, warm), quarantine
    assert len(port) == 1 + 3 * 3 + 2 + 1


# ---------------------------------------------------------------------
# DataPlane
# ---------------------------------------------------------------------


class _Plane:
    """One package's arena tree registered on its own DataPlane."""

    def __init__(self, pkg, d, **tree_kw):
        self.m = PKGS[pkg]
        tree_kw.setdefault("memtable_kind", "arena")
        self.tree = self.m.tree(d, **tree_kw)
        self.dp = self.m.dp.create_dataplane()
        assert self.dp is not None
        self.dp.set_ownership(1)
        self.dp.register_tree("c", self.tree)
        self.flushes = []

    def handle(self, frame):
        """try_handle's tuple with the flush tree named, or None; the
        flushes it asks for are spawned as the db server does."""
        got = self.dp.try_handle(frame)
        if got is None:
            return None
        resp, keepalive, flush_tree, op, defer, extra = got
        if flush_tree is not None:
            self.flushes.append(asyncio.ensure_future(flush_tree.flush()))
        return (bytes(resp), keepalive,
                "c" if flush_tree is self.tree else flush_tree,
                op, defer is not None, extra)

    async def drain(self):
        await asyncio.gather(*self.flushes)
        self.flushes.clear()
        for _ in range(5):
            await asyncio.sleep(0.01)


def _frame(rtype, key=None, value=None, **extra):
    body = {"type": rtype, "collection": "c"}
    if key is not None:
        body["key"] = key
    if value is not None:
        body["value"] = value
    body.update(extra)
    return codec.packb(body)


def _multi_ops(keys, values=None):
    out = []
    for i, k in enumerate(keys):
        op = [k, thash(codec.packb(k))]
        if values is not None:
            op.append(values[i])
        out.append(op)
    return out


def _scenario_frames(name, rng):
    """(frames, ownership) of one scenario; a frame may be a callable
    taking the plane (for steps that are not frames)."""
    keys = ["k%03d" % i for i in range(24)]
    if name == "set_get_delete":
        frames = [_frame("set", k, {"v": int(rng.integers(1 << 40))})
                  for k in keys]
        frames += [_frame("get", k) for k in keys[::2]]
        frames += [_frame("delete", k) for k in keys[:5]]
        frames += [_frame("get", k) for k in keys[:8]]
        frames += [_frame("get", "absent"),
                   _frame("set", b"\x00raw", [1, "x"], keepalive=True),
                   _frame("get", b"\x00raw", keepalive=True)]
        return frames, None
    if name == "multi":
        vals = [{"i": i} for i in range(6)]
        tricky = ["plain", "uni-é中", b"raw", b"\x00\xff\x7f", "x" * 40,
                  "k001"]
        return [
            _frame("set", "k001", 1),
            _frame("multi_set", ops=_multi_ops(tricky, vals),
                   replica_index=0, timeout=5000, keepalive=True),
            _frame("multi_get", ops=_multi_ops(tricky + ["absent"]),
                   replica_index=0, timeout=5000),
            _frame("multi_get", ops=[]),
        ], None
    if name == "unknown_type":
        return [_frame("frobnicate", "k001", 1), _frame("set", "k001", 1),
                codec.packb({"type": "get"}), b"\xc1", b""], None
    if name == "unowned":
        # Own a narrow arc: keys outside it punt, keys inside serve.
        hashes = sorted(thash(codec.packb(k)) for k in keys)
        lo, hi = hashes[5], hashes[15]
        return ([_frame("set", k, i) for i, k in enumerate(keys)]
                + [_frame("get", k) for k in keys]), (2, lo, hi)
    if name == "non_minimal_key":
        good = _frame("set", "KEYPH", 7)
        bad = good.replace(b"\xa5KEYPH", b"\xd9\x05KEYPH")
        big = good.replace(b"\xa5KEYPH", b"\xda\x00\x05KEYPH")
        return [bad, big, good, _frame("get", "KEYPH"),
                codec.packb({"type": "get", "collection": "c"}).replace(
                    b"\x82", b"\x83", 1) + b"\xa3key\xd9\x05KEYPH"], None
    if name == "big_value":
        blob = rng.bytes(300_000)
        return [_frame("set", "big", blob), _frame("get", "big"),
                _frame("set", "small", 1), _frame("get", "small"),
                _frame("get", "big")], None
    if name == "full_memtable":
        frames = [_frame("set", "f%03d" % i, i) for i in range(40)]
        frames.append("drain")
        frames += [_frame("set", "g%03d" % i, i) for i in range(20)]
        frames.append("drain")
        frames += [_frame("get", "f%03d" % i) for i in range(0, 40, 3)]
        return frames, None
    raise ValueError(name)


def _run_scenario(pkg, d, name):
    rng = np.random.default_rng(11)
    frames, own = _scenario_frames(name, rng)
    out = []

    async def main():
        p = _Plane(pkg, d, capacity=16 if name == "full_memtable" else 256)
        if own is not None:
            p.dp.set_ownership(*own)
        for f in frames:
            if f == "drain":
                await p.drain()
                out.append("drained")
                continue
            out.append(p.handle(f))
        await p.drain()
        out.append(("buf", p.dp._buf_cap))
        stats = p.dp.stats()
        out.append(("stats", {k: v for k, v in stats.items()
                              if not k.startswith("fast_table")}))
        p.tree.close()

    run(main(), timeout=30)
    return out


@pytest.mark.parametrize("name", [
    "set_get_delete", "multi", "unknown_type", "unowned",
    "non_minimal_key", "big_value", "full_memtable",
])
def test_try_handle_equals_reference(tmp_path, name):
    """Byte-equal try_handle tuples (response, keepalive, flush tree,
    op, defer, extra), punts on the same frames, equal stats."""
    ref = _run_scenario("ref", str(tmp_path / "ref"), name)
    port = _run_scenario("port", str(tmp_path / "port"), name)
    assert port == ref
    handled = [x for x in port if isinstance(x, tuple) and len(x) == 6]
    punts = [x for x in port if x is None]
    if name in ("unknown_type", "unowned", "non_minimal_key",
                "full_memtable"):
        assert punts, "the scenario must punt somewhere"
    if name != "unknown_type":
        assert handled, "the scenario must serve natively somewhere"
    if name == "big_value":
        assert dict([port[-2]])["buf"] > tdp._GET_BUF_CAP, "no growth"
    if name == "full_memtable":
        assert any(x[2] == "c" for x in handled), "no flush asked for"


def _rwf_nowait_supported(d):
    if not hasattr(os, "RWF_NOWAIT"):
        return False
    p = os.path.join(d, "nowait-probe")
    with open(p, "wb") as f:
        f.write(b"x" * 4096)
    fd = os.open(p, os.O_RDONLY)
    try:
        return os.preadv(fd, [bytearray(16)], 0, os.RWF_NOWAIT) == 16
    except OSError:
        return False
    finally:
        os.close(fd)
        os.unlink(p)


def _table_gets(pkg, d):
    keys = ["t%04d" % i for i in range(300)]
    rng = np.random.default_rng(5)
    vals = {k: {"v": int(rng.integers(1 << 50)), "p": "x" * int(rng.integers(40))}
            for k in keys}
    out = []

    async def main():
        p = _Plane(pkg, d, capacity=64)
        for k in keys:
            if p.handle(_frame("set", k, vals[k])) is None:
                await p.drain()
                assert p.handle(_frame("set", k, vals[k])) is not None
        await p.drain()
        await p.tree.flush()
        await p.drain()
        tables = [i for i, _ in p.tree.sstable_indices_and_sizes()]
        await p.tree.compact(tables, max(tables) + 1, keep_tombstones=False)
        await p.drain()
        before = p.dp.stats()["fast_table_gets"]
        for k in keys + ["absent"]:
            out.append(p.handle(_frame("get", k)))
        out.append(("table_gets", p.dp.stats()["fast_table_gets"] - before))
        out.append(("tables", len(p.tree._sstables.tables),
                    p.tree.memtable_entries))
        p.tree.close()

    run(main(), timeout=30)
    return out, vals


def test_gets_served_from_flushed_and_compacted_tables(tmp_path):
    """After the flushes and a cpu-strategy compaction every get is
    served natively from the one table (flag 4, op "get") with bytes
    equal between packages and equal to the oracle's encoding."""
    ref, _ = _table_gets("ref", str(tmp_path / "ref"))
    port, vals = _table_gets("port", str(tmp_path / "port"))
    assert port == ref
    assert port[-1] == ("tables", 1, 0)
    if not _rwf_nowait_supported(str(tmp_path)):
        assert all(x is None for x in port[:-2])  # every probe punts
        return
    assert port[-2] == ("table_gets", len(vals) + 1)
    for got, (k, v) in zip(port, vals.items()):
        assert got[3] == "get" and got[0][4:-1] == codec.packb(v)
        assert got[0][-1] == 1  # RESPONSE_OK


def _sync_defer(pkg, d):
    out = []

    async def main():
        p = _Plane(pkg, d, capacity=256, wal_sync=True)
        for i in range(12):
            got = p.dp.try_handle(_frame("set", "s%02d" % i, i))
            assert got is not None
            defer = got[4]
            assert defer is not None, "no deferred ack under wal_sync"
            syncer, ticket = defer
            done = asyncio.get_event_loop().create_future()
            syncer.park(ticket, lambda f=done: f.set_result(True))
            await asyncio.wait_for(done, 5)
            out.append((bytes(got[0]), got[3], ticket,
                        p.tree._wal._lib.dbeel_wal_synced(
                            p.tree._wal._native) >= ticket))
        p.tree.close()

    run(main(), timeout=30)
    return out


def test_wal_sync_defers_until_the_ticket_is_covered(tmp_path):
    """Under wal_sync each set's defer is (syncer, ticket); the ticket
    is covered once the park fires.  Equal (response, op, ticket,
    covered) between packages."""
    ref = _sync_defer("ref", str(tmp_path / "ref"))
    port = _sync_defer("port", str(tmp_path / "port"))
    assert port == ref
    assert all(x[3] for x in port)
    assert [x[2] for x in port] == sorted(x[2] for x in port)


def test_armed_disk_faults_punt_writes(tmp_path):
    """With the disk-fault seam armed the C write path is not given the
    WAL: sets punt (to the guarded Python path) in both packages while
    gets still serve."""
    out = {}
    for pkg in ("ref", "port"):
        m = PKGS[pkg]

        async def main():
            p = _Plane(pkg, str(tmp_path / pkg), capacity=64)
            first = p.handle(_frame("set", "a", 1))
            m.file_io._faults["/nonexistent-prefix"] = "enospc"
            try:
                p.dp.register_tree("c", p.tree)
                got = [p.handle(_frame("set", "b", 2)),
                       p.handle(_frame("get", "a"))]
            finally:
                m.file_io._faults.pop("/nonexistent-prefix", None)
            p.dp.register_tree("c", p.tree)
            got.append(p.handle(_frame("set", "b", 2)))
            p.tree.close()
            return [first] + got

        out[pkg] = run(main(), timeout=30)
    assert out["port"] == out["ref"]
    assert out["port"][1] is None and out["port"][2] is not None
    assert out["port"][3] is not None


def test_stats_and_trace_keys_equal(tmp_path):
    """Equal stats() and trace_stats() key sets (and the counters of a
    fresh plane), and equal per-class counters after a shed."""
    got = {}
    for pkg in ("ref", "port"):
        m = PKGS[pkg]
        dp = m.dp.create_dataplane()
        dp.set_trace(True)
        dp.set_class_levels([0, 0, 2])
        dp.set_overload(0)
        got[pkg] = (dp.stats(), sorted(dp.trace_stats()),
                    dp.sheds_by_class(), dp.admits_by_class(),
                    dp.shed_armed)
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------------
# QuorumFanout
# ---------------------------------------------------------------------


class _Replica:
    """A fake replica on 127.0.0.1:0: records every byte it receives and
    answers each u32-framed request with ``ack`` (or closes the
    connection after ``close_after`` requests)."""

    def __init__(self, ack, close_after=None):
        self.ack = ack
        self.close_after = close_after
        self.received = bytearray()
        self.served = 0

    async def start(self):
        self.server = await asyncio.start_server(
            self._conn, "127.0.0.1", 0)
        self.port = self.server.sockets[0].getsockname()[1]
        return self

    async def _conn(self, reader, writer):
        try:
            while True:
                hdr = await reader.readexactly(4)
                (n,) = struct.unpack("<I", hdr)
                body = await reader.readexactly(n)
                self.received += hdr + body
                if (self.close_after is not None
                        and self.served >= self.close_after):
                    writer.close()
                    return
                self.served += 1
                writer.write(struct.pack("<I", len(self.ack)) + self.ack)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    def close(self):
        self.server.close()


class _FanShard:
    """What QuorumFanout reads of its shard: spawn, the two timeouts,
    and the hint recorder."""

    def __init__(self):
        self.config = SimpleNamespace(remote_shard_connect_timeout_ms=2000,
                                      remote_shard_read_timeout_ms=5000)
        self.tasks = set()
        self.hints = []

    def spawn(self, coro):
        t = asyncio.ensure_future(coro)
        self.tasks.add(t)
        t.add_done_callback(self.tasks.discard)
        return t

    def _record_hint(self, name, request):
        self.hints.append((name, request))


def _fanout_run(pkg, n_ops, close_after=None):
    m = PKGS[pkg]
    ack = m.msgs.pack_message(["response", m.msgs.ShardResponse.SET])

    async def main():
        reps = [await _Replica(ack).start(),
                await _Replica(ack, close_after).start()]
        shard = _FanShard()
        qf = m.qf.create_quorum_fanout(shard)
        assert qf is not None
        conns = [("node%d" % i, SimpleNamespace(address="127.0.0.1:%d" % r.port))
                 for i, r in enumerate(reps)]
        frames = []
        for i in range(n_ops):
            req = m.msgs.ShardRequest.set("c", b"key-%05d" % i,
                                          b"v" * (i % 50), 1000 + i)
            packed = m.msgs.pack_message(req)
            frames.append(struct.pack("<I", len(packed)) + packed)
        first = qf.try_submit(frames[0], conns, 2, ack, "set",
                              lambda: None)
        for _ in range(200):
            if all(qf._lib.dbeel_qf_stream_alive(qf._handle, p)
                   for p in range(2)):
                break
            await asyncio.sleep(0.01)
        futs = []
        for i, f in enumerate(frames):
            fut = qf.try_submit(
                f, conns, 2, ack, "set",
                lambda f=f: m.msgs.unpack_message(f[4:]))
            assert fut is not None, i
            futs.append(fut)
            if i % 64 == 63:
                await asyncio.sleep(0)
        results = await asyncio.wait_for(asyncio.gather(*futs), 20)
        stats = qf.stats()
        hints = [(n, r) for n, r in shard.hints]
        qf.close()
        for r in reps:
            r.close()
        return (first, results, stats, hints,
                [bytes(r.received) for r in reps], frames)

    return run(main(), timeout=40)


def test_fanout_sends_equal_bytes_and_resolves_every_quorum():
    """Each replica receives exactly the submitted frames, in order, in
    both packages (equal bytes); every future resolves to two acks."""
    ref = _fanout_run("ref", 300)
    port = _fanout_run("port", 300)
    first, results, stats, hints, received, frames = port
    assert first is None  # no live stream yet: the caller falls back
    assert received == ref[4]
    assert received[0] == b"".join(frames) == received[1]
    assert results == ref[1] == [[None, None]] * 300
    assert stats == ref[2] == {"fast_fanout_ops": 300}
    assert hints == ref[3] == []


def test_fanout_replica_closing_mid_stream_degrades_equally():
    """A replica that closes after 100 requests: every op still
    resolves (no lost ack), the later ones with the live replica's ack
    alone, and each unanswered op is hinted — equal in both packages."""
    ref = _fanout_run("ref", 200, close_after=100)
    port = _fanout_run("port", 200, close_after=100)
    assert port[1] == ref[1]
    assert port[1][:100] == [[None, None]] * 100
    assert all(r == [None] for r in port[1][100:])
    assert port[3] == ref[3] and len(port[3]) == 100
    assert port[4] == ref[4]


def test_try_submit_without_a_live_stream_returns_none():
    """No stream to a peer that refuses connections: try_submit is None
    every time, in both packages, and nothing is hinted."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port_no = s.getsockname()[1]
    s.close()  # nothing listens there now
    got = {}
    for pkg in ("ref", "port"):
        m = PKGS[pkg]

        async def main():
            shard = _FanShard()
            qf = m.qf.create_quorum_fanout(shard)
            conns = [("dead", SimpleNamespace(
                address="127.0.0.1:%d" % port_no))]
            out = []
            for _ in range(3):
                out.append(qf.try_submit(b"\x01\x00\x00\x00\x90", conns, 1,
                                         b"", "set", lambda: None))
                await asyncio.sleep(0.05)
            out.append(qf.try_submit(b"x", [], 1, b"", "set", lambda: None))
            stats = qf.stats()
            qf.close()
            return out, shard.hints, stats, qf.stats()

        got[pkg] = run(main(), timeout=20)
    assert got["port"] == got["ref"]
    assert got["port"][0] == [None] * 4
    assert got["port"][3] == {"fast_fanout_ops": None}
