"""The planes that read trees — migration, the scan plane's coordinator
and the watch plane — of dbeel_tpu_torch against dbeel_tpu.

The peer handlers that answer SCAN and WATCH_FEED frames live in the
shard, which the port does not have yet (ROADMAP Queue 1 item 5(c)):
``StubShard`` below stands in for it, doing what those handlers do —
``scan_filter_page``/``scan_page`` under the same clamps, ``eval_path``
counted, ``ShardResponse.scan(...)`` and the watch plane's
``feed_page`` answered.  Each package gets its own stub built from its
own modules and its own trees, written with the same seeded
``set_with_timestamp`` calls.  Every comparison is stated at its
assert: chunk payloads byte-equal between packages and equal to a dict
oracle, ShardEvent messages equal in packed bytes, journals equal as
JSON."""

import asyncio
import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from conftest import run

from dbeel_tpu import config as jconfig
from dbeel_tpu import errors as jerrors
from dbeel_tpu import query as jquery
from dbeel_tpu.cluster import local_comm as jlocal
from dbeel_tpu.cluster import messages as jmsgs
from dbeel_tpu.server import governor as jgov
from dbeel_tpu.server import metrics as jmetrics
from dbeel_tpu.server import migration as jmig
from dbeel_tpu.server import qos as jqos
from dbeel_tpu.server import scan as jscan
from dbeel_tpu.server import scheduler as jsched
from dbeel_tpu.server import shard as jshard
from dbeel_tpu.server import watch as jwatch
from dbeel_tpu.storage import LSMTree as JTree
from dbeel_tpu.storage.compaction import get_strategy as jget
from dbeel_tpu_torch import config as tconfig
from dbeel_tpu_torch import errors as terrors
from dbeel_tpu_torch import query as tquery
from dbeel_tpu_torch.cluster import local_comm as tlocal
from dbeel_tpu_torch.cluster import messages as tmsgs
from dbeel_tpu_torch.server import governor as tgov
from dbeel_tpu_torch.server import metrics as tmetrics
from dbeel_tpu_torch.server import migration as tmig
from dbeel_tpu_torch.server import qos as tqos
from dbeel_tpu_torch.server import scan as tscan
from dbeel_tpu_torch.server import scheduler as tsched
from dbeel_tpu_torch.server import shard as tshard
from dbeel_tpu_torch.server import watch as twatch
from dbeel_tpu_torch.storage import LSMTree as TTree
from dbeel_tpu_torch.storage.compaction import get_strategy as tget
from dbeel_tpu_torch.utils import msgpack_codec as codec
from dbeel_tpu_torch.utils.murmur import hash_bytes as thash

PKGS = {
    "ref": SimpleNamespace(
        config=jconfig, errors=jerrors, query=jquery, local=jlocal,
        msgs=jmsgs, governor=jgov, metrics=jmetrics, mig=jmig, qos=jqos,
        scan=jscan, sched=jsched, shard=jshard, watch=jwatch,
        tree=lambda d, **kw: JTree.open_or_create(
            d, strategy=jget("heap"), **kw)),
    "port": SimpleNamespace(
        config=tconfig, errors=terrors, query=tquery, local=tlocal,
        msgs=tmsgs, governor=tgov, metrics=tmetrics, mig=tmig, qos=tqos,
        scan=tscan, sched=tsched, shard=tshard, watch=twatch,
        tree=lambda d, **kw: TTree.open_or_create(
            d, strategy=tget("heap"), device="cpu", **kw)),
}


class Clock:
    """The watch and scan planes' injected ``time``: one fixed wall
    clock, so boot epochs, late-commit flags and flag windows agree."""

    def __init__(self, t0=1000.0):
        self.t = t0

    def monotonic(self):
        return self.t

    def time(self):
        return 1.7e9 + self.t

    def time_ns(self):
        return int(self.time() * 1e9)


NOW_NS = Clock().time_ns()


@pytest.fixture
def clocked(monkeypatch):
    for m in PKGS.values():
        monkeypatch.setattr(m.watch, "time", Clock())
        monkeypatch.setattr(m.scan, "time", Clock())


# ---------------------------------------------------------------------
# The stub shard (standing in for MyShard, ROADMAP item 5(c))
# ---------------------------------------------------------------------


class RingEntry:
    def __init__(self, node_name, name, h, connection=None):
        self.node_name = node_name
        self.name = name
        self.hash = h
        self.connection = connection


class PeerConn:
    """A remote-shard connection to another stub: ``send_request``
    runs that stub's peer handler (the wire is not the point here)."""

    def __init__(self, target):
        self.target = target

    async def send_request(self, req):
        return await self.target.handle_shard_request(req)


class StubShard:
    """What the scan, watch and migration planes read of MyShard, and
    the SCAN / WATCH_FEED peer handlers of ``MyShard.
    handle_shard_request`` (the same clamps and eval_path counting)."""

    def __init__(self, m, name, node_name, tree, rf, cfg, sid=0):
        self.m = m
        self.id = sid
        self.shard_name = name
        self.node_name = node_name
        self.config = cfg
        self.collections = {"c": SimpleNamespace(
            tree=tree, replication_factor=rf)}
        self.ring = []
        self.dead_nodes = set()
        self.membership_epoch = 1
        self._migration_tasks = set()
        self.fence_refusals = 0
        self.migrations_cancelled = 0
        self.migrations_resumed = 0
        self.keys_migrated = 0
        self.bytes_migrated = 0
        self.dataplane = None
        self.db_connections = []
        self.metrics = m.metrics.ShardMetrics()
        self.scheduler = m.sched.ShareScheduler()
        self.governor = m.governor.LoadGovernor(self, cfg)
        # No loop-lag heartbeat: a test host's wall-clock stalls (first
        # imports, executor builds) would move the level between the
        # two packages' runs; every other signal is deterministic.
        self.governor._hb_task = SimpleNamespace(done=lambda: False)
        self.qos = m.qos.QosPlane(self, cfg)
        self.scan_plane = m.scan.ScanPlane(self, cfg)
        self.watch_plane = m.watch.WatchPlane(self, cfg)
        self.flow = SimpleNamespace(notify=lambda *_a: None)
        self.tasks = set()
        tree.on_commit = (
            lambda k, v, ts: self.watch_plane.publish("c", k, v, ts))

    @property
    def shards(self):
        return self.ring

    def spawn(self, coro):
        t = asyncio.ensure_future(coro)
        self.tasks.add(t)
        t.add_done_callback(self.tasks.discard)
        return t

    def _migration_task_done(self, task):
        self._migration_tasks.discard(task)

    def _refresh_dataplane_ownership(self):
        pass

    def get_collection(self, name):
        col = self.collections.get(name)
        if col is None:
            raise self.m.errors.CollectionNotFound(name)
        return col

    def _in_ae_range(self, h, start, end):
        return start == end or self.m.mig._between(h, start, end)

    def all_arcs(self, rf):
        """MyShard.all_arcs: every ring arc with its rf-distinct-node
        replica walk, +1-shifted half-open bounds, equal-set arcs
        merged."""
        ring = sorted(self.ring, key=lambda s: s.hash)
        n = len(ring)
        if n == 1:
            s = (ring[0].hash + 1) & 0xFFFFFFFF
            return [(s, s, [ring[0]])]
        arcs = []
        for i in range(n):
            nodes, selected = set(), []
            for off in range(n):
                s = ring[(i + off) % n]
                if s.node_name in nodes:
                    continue
                nodes.add(s.node_name)
                selected.append(s)
                if len(nodes) >= rf:
                    break
            arcs.append([(ring[i - 1].hash + 1) & 0xFFFFFFFF,
                         (ring[i].hash + 1) & 0xFFFFFFFF, selected])
        merged = []
        for arc in arcs:
            if (merged and merged[-1][1] == arc[0]
                    and {s.name for s in merged[-1][2]}
                    == {s.name for s in arc[2]}):
                merged[-1][1] = arc[1]
            else:
                merged.append(arc)
        if (len(merged) > 1 and merged[-1][1] == merged[0][0]
                and {s.name for s in merged[-1][2]}
                == {s.name for s in merged[0][2]}):
            merged[0][0] = merged[-1][0]
            merged.pop()
        return [(s, e, p) for s, e, p in merged]

    async def handle_shard_request(self, request):
        R, Resp = self.m.msgs.ShardRequest, self.m.msgs.ShardResponse
        kind = request[1]
        if kind == R.SCAN:
            col = self.collections.get(request[2])
            if col is None:
                return Resp.scan([], False)
            start_after = (bytes(request[5]) if request[5] is not None
                           else None)
            prefix = bytes(request[6]) if request[6] else None
            limit = max(1, min(int(request[7]), 65536))
            max_bytes = max(4096, min(int(request[8]), 16 << 20))
            spec = request[10] if len(request) > 10 else None
            self.qos.note_peer(self.m.qos.class_of(request[11])
                               if len(request) > 11
                               else self.m.qos.QOS_BATCH)
            if spec is not None:
                where, agg, mode = self.m.query.unpack_peer_spec(spec)
                (entries, more, cover, rows, sbytes, partial,
                 eval_path) = await col.tree.scan_filter_page(
                    int(request[3]), int(request[4]), start_after, prefix,
                    limit, max_bytes, bool(request[9]), where, agg, mode)
                plane = self.scan_plane
                if eval_path == "device":
                    plane.device_evals += 1
                elif eval_path == "indexed":
                    plane.indexed_evals += 1
                elif eval_path in ("numpy", "golden"):
                    plane.fallback_evals += 1
                if partial is not None:
                    plane.agg_partials += 1
                return Resp.scan(entries, more, cover, rows, sbytes,
                                 partial)
            entries, more = await col.tree.scan_page(
                int(request[3]), int(request[4]), start_after, prefix,
                limit, max_bytes, bool(request[9]))
            return Resp.scan(entries, more)
        if kind == R.WATCH_FEED:
            self.watch_plane.suspend_native(request[2])
            ranges = ([[int(r[0]), int(r[1])] for r in request[5]]
                      if request[5] else None)
            limit = max(1, min(int(request[6]), 65536))
            max_bytes = max(4096, min(int(request[7]), 16 << 20))
            spec = request[8] if len(request) > 8 else None
            events, boot, tail, status = self.watch_plane.feed_page(
                request[2], int(request[3]), int(request[4]), ranges,
                limit, max_bytes, bytes(spec) if spec is not None else None)
            return Resp.watch_feed(events, boot, tail, status)
        raise self.m.errors.DbeelError(f"unknown shard request {kind!r}")


def _config(m, **kw):
    return m.config.parse_args([]).replace(**kw)


async def _cluster(pkg, d, rf, writes, **cfg_kw):
    """One coordinator stub over ``rf`` replica stubs (distinct nodes,
    fixed ring hashes); ``writes[i]`` lists replica i's (key, value,
    ts) writes, value b"" a delete.  Returns (coordinator, stubs).  Run
    on the loop that then drives the planes: the governor's lag
    heartbeat belongs to one loop."""
    m = PKGS[pkg]
    cfg = _config(m, **cfg_kw)
    hashes = [0x40000000, 0x90000000, 0xE0000000][:rf]
    stubs = []
    for i in range(rf):
        tree = m.tree(os.path.join(d, pkg, "r%d" % i), capacity=4096)
        stubs.append(StubShard(m, "s%d" % i, "n%d" % i, tree, rf, cfg,
                               sid=i))
    ring = [RingEntry("n%d" % i, "s%d" % i, hashes[i],
                      PeerConn(stubs[i])) for i in range(rf)]
    for s in stubs:
        s.ring = ring
    for s, w in zip(stubs, writes):
        tree = s.collections["c"].tree
        for key, value, ts in w:
            if value == b"":
                await tree.delete_with_timestamp(key, ts)
            else:
                await tree.set_with_timestamp(key, value, ts)
    return stubs[0], stubs


def _close(stubs):
    """Close every tree (an unclosed WAL closes itself from ``__del__``,
    which can run inside the executor's submit and deadlock it)."""
    for s in stubs:
        s.collections["c"].tree.close()


def _docs(seed, n):
    rng = np.random.default_rng(seed)
    cities = ["ams", "ber", "cph", "dub", "edi"]
    out = []
    for i in range(n):
        key = codec.packb("doc-%05d" % i)
        doc = {"v": int(rng.integers(0, 1000)),
               "city": cities[int(rng.integers(0, len(cities)))],
               "pad": "x" * int(rng.integers(0, 30))}
        out.append((key, codec.packb(doc), 1_000_000 + i))
    return out


def _replica_writes(seed, n, rf):
    """Every replica gets the docs; replica 1 (rf 3) then holds newer
    versions of some keys and newer tombstones of others, and replica
    2 misses the newest writes entirely (it is stale)."""
    base = _docs(seed, n)
    rng = np.random.default_rng(seed + 100)
    newer = []
    for key, _v, ts in base:
        r = rng.random()
        if r < 0.08:
            newer.append((key, b"", ts + 10_000_000))
        elif r < 0.2:
            doc = {"v": int(rng.integers(0, 1000)), "city": "new"}
            newer.append((key, codec.packb(doc), ts + 10_000_000))
    if rf == 1:
        return [base + newer], base + newer
    return [base, base + newer, base[: n // 2]], base + newer


def _oracle(all_writes):
    live = {}
    for key, value, ts in all_writes:
        cur = live.get(key)
        if cur is None or ts > cur[1]:
            live[key] = (value, ts)
    return [(k, v) for k, (v, _ts) in sorted(live.items()) if v != b""]


async def _stream(plane, first):
    """scan / scan_next until the cursor is nil: the payloads."""
    payloads = [await plane.handle(first, "scan")]
    while True:
        cur = codec.unpackb(payloads[-1])["cursor"]
        if cur is None:
            return payloads
        payloads.append(await plane.handle({"cursor": cur}, "scan_next"))


def _scan_both(tmp_path, rf, request, seed=1, n=700, **cfg_kw):
    writes, flat = _replica_writes(seed, n, rf)
    out = {}
    for pkg in ("ref", "port"):

        async def main():
            coord, stubs = await _cluster(pkg, str(tmp_path), rf, writes,
                                          **cfg_kw)
            chunks = await _stream(coord.scan_plane, dict(request))
            _close(stubs)
            return chunks, coord.scan_plane.stats()

        out[pkg] = run(main(), timeout=60)
    assert out["port"][0] == out["ref"][0]  # byte-equal chunks
    assert out["port"][1] == out["ref"][1]
    return out["port"][0], _oracle(flat), out["port"][1]


def _entries(payloads):
    rows = []
    for p in payloads:
        rows += [(codec.packb(k), codec.packb(v))
                 for k, v in codec.unpackb(p)["entries"]]
    return rows


# ---------------------------------------------------------------------
# Migration
# ---------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["_between", "_in_migration_range"])
@settings(max_examples=400, deadline=None)
@given(h=st.integers(0, 0xFFFFFFFF), start=st.integers(0, 0xFFFFFFFF),
       end=st.integers(0, 0xFFFFFFFF))
def test_range_membership_agrees(fn, h, start, end):
    """Equal booleans over (hash, start, end), wrap-around included."""
    assert getattr(tmig, fn)(h, start, end) == getattr(jmig, fn)(h, start, end)


@pytest.mark.parametrize("fn", ["_between", "_in_migration_range"])
@pytest.mark.parametrize("h,start,end", [
    (0, 0, 0), (5, 5, 6), (6, 5, 6), (0, 0xFFFFFFF0, 10),
    (0xFFFFFFFF, 0xFFFFFFF0, 10), (10, 0xFFFFFFF0, 10), (1, 1, 0),
])
def test_range_membership_edges_agree(fn, h, start, end):
    assert getattr(tmig, fn)(h, start, end) == getattr(jmig, fn)(h, start, end)


def _local_target(m, shard, after=None, fail_after=None):
    """A LocalShardConnection whose shard's membership epoch moves on
    after ``after`` messages, or which fails after ``fail_after``."""
    conn = m.local.LocalShardConnection(7)
    real = conn.send_message
    count = [0]

    async def send_message(source_id, message):
        count[0] += 1
        if fail_after is not None and count[0] > fail_after:
            raise RuntimeError("target crashed")
        await real(source_id, message)
        if after is not None and count[0] == after:
            shard.membership_epoch += 1

    conn.send_message = send_message
    return conn


def _drain(conn):
    out = []
    while not conn.queue.empty():
        pkt = conn.queue.get_nowait()
        out.append(pkt.message)
    return out


@pytest.fixture
def journals(monkeypatch):
    """Every migration journal written, as (file name, JSON), captured
    at its atomic replace."""
    seen = []
    real = os.replace

    def spy(src, dst):
        if os.path.basename(str(dst)).startswith("migration-"):
            with open(src) as f:
                seen.append((os.path.basename(str(dst)), json.load(f)))
        return real(src, dst)

    monkeypatch.setattr(os, "replace", spy)
    return seen


def _migrate(pkg, d, arcs, epoch_after=None, fail_after=None):
    m = PKGS[pkg]
    cfg = _config(m, dir=d)
    writes = _docs(4, 900)
    tree = m.tree(os.path.join(d, "tree"), capacity=4096)
    shard = StubShard(m, "s0", "n0", tree, 1, cfg)

    async def main():
        for key, value, ts in writes:
            await tree.set_with_timestamp(key, value, ts)
        await tree.flush()
        target = _local_target(m, shard, epoch_after, fail_after)
        shard.ring = [RingEntry("n0", "s0", 1), RingEntry("n1", "s1", 2,
                                                          target)]
        ranges = [m.shard.RangeAndAction(s, e, act, target)
                  for s, e, act in arcs]
        err = None
        try:
            await m.mig.migrate_actions(shard, "c", tree, ranges,
                                        plan_epoch=1)
        except RuntimeError as e:
            err = str(e)
        msgs = _drain(target)
        tree.close()
        return ([m.msgs.pack_message(x) for x in msgs], err,
                shard.keys_migrated, shard.bytes_migrated,
                shard.migrations_cancelled, sorted(os.listdir(d)))

    return run(main(), timeout=60)


_ARCS = {
    "quarter": [(0x10000000, 0x50000000, "send")],
    "wrap": [(0xE0000000, 0x20000000, "send"),
             (0x60000000, 0x70000000, "send")],
    "delete": [(0x30000000, 0x60000000, "delete"),
               (0x80000000, 0x90000000, "send")],
}


@pytest.mark.parametrize("arcs", sorted(_ARCS))
def test_migrate_actions_events_and_journal_equal(tmp_path, journals, arcs):
    """The queued ShardEvent messages are equal in order and packed
    bytes; the journals written are equal JSON (the last says every
    arc done); the keys sent are exactly the oracle's keys in range."""
    got = {}
    for pkg in ("ref", "port"):
        journals.clear()
        d = str(tmp_path / pkg)
        os.makedirs(d)
        got[pkg] = (_migrate(pkg, d, _ARCS[arcs]), list(journals))
    assert got["port"] == got["ref"]
    (msgs, err, n_keys, _b, cancelled, files), jr = got["port"]
    assert err is None and cancelled == 0
    assert "migration-0-c.json" not in files  # removed once done
    assert all(a["done"] for a in jr[-1][1]["arcs"])
    want = [k for k, _v, _ts in _docs(4, 900)
            if any(act == "send" and tmig._in_migration_range(
                thash(k), s, e) for s, e, act in _ARCS[arcs])]
    sent = [codec.unpackb(x)[3] for x in msgs] if msgs else []
    assert sorted(bytes(k) for k in sent) == sorted(want)
    assert n_keys == len(want)


def test_epoch_change_cancels_both_at_the_same_page(tmp_path, journals):
    """An epoch bump after 200 messages: both packages stop at the end
    of the same page — equal messages, one cancellation, journal gone."""
    got = {}
    for pkg in ("ref", "port"):
        d = str(tmp_path / pkg)
        os.makedirs(d)
        got[pkg] = _migrate(pkg, d, [(0, 0xFFFFFFFF, "send")],
                            epoch_after=200)
    assert got["port"] == got["ref"]
    msgs, err, n_keys, _b, cancelled, files = got["port"]
    assert cancelled == 1 and err is None
    assert len(msgs) == 256  # two pages of MIGRATION_BATCH_ENTRIES
    assert "migration-0-c.json" not in files


def test_resume_from_a_reference_journal(tmp_path):
    """The reference crashes part way (its target fails after 300
    messages), leaving its journal; the port's resume_migrations picks
    that journal up and sends exactly what the reference's own resume
    sends from a copy of it (equal packed bytes), the rest of the arc."""
    arcs = [(0x00000000, 0x80000000, "send"), (0x90000000, 0xA0000000,
                                                "send")]
    ref_dir = str(tmp_path / "crash")
    os.makedirs(ref_dir)
    msgs, err, *_rest, files = _migrate("ref", ref_dir, arcs,
                                        fail_after=300)
    assert err == "target crashed" and "migration-0-c.json" in files
    journal = os.path.join(ref_dir, "migration-0-c.json")
    with open(journal) as f:
        state = json.load(f)
    assert state["arcs"][0]["cursor"] and not state["arcs"][0]["done"]

    got = {}
    for pkg in ("ref", "port"):
        m = PKGS[pkg]
        d = str(tmp_path / ("resume-" + pkg))
        os.makedirs(d)
        shutil.copy(journal, d)
        cfg = _config(m, dir=d)
        tree = m.tree(os.path.join(d, "tree"), capacity=4096)
        shard = StubShard(m, "s0", "n0", tree, 1, cfg)

        async def main():
            for key, value, ts in _docs(4, 900):
                await tree.set_with_timestamp(key, value, ts)
            target = m.local.LocalShardConnection(7)
            shard.ring = [RingEntry("n0", "s0", 1),
                          RingEntry("n1", state["arcs"][0]["target"], 2,
                                    target)]
            await m.mig.resume_migrations(shard)
            await asyncio.gather(*list(shard._migration_tasks))
            out = [m.msgs.pack_message(x) for x in _drain(target)]
            tree.close()
            return (out, shard.migrations_resumed, shard.keys_migrated,
                    sorted(os.listdir(d)))

        got[pkg] = run(main(), timeout=60)
    assert got["port"] == got["ref"]
    sent, resumed, n_keys, files = got["port"]
    assert resumed == 1 and n_keys == len(sent) > 0
    assert "migration-0-c.json" not in files
    cursor = bytes.fromhex(state["arcs"][0]["cursor"])
    first = bytes(codec.unpackb(sent[0])[3])
    assert first > cursor  # resumed past the journal's cursor


# ---------------------------------------------------------------------
# Scan plane: helpers and cursors
# ---------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_scan_helpers_equal_bytes(seed):
    """pack_chunk, encode_cursor, iter_winners and _scan_result give
    equal bytes / values in both packages on seeded inputs."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 40))
    rows = [(codec.packb("k%03d" % int(rng.integers(0, 20))),
             codec.packb({"v": int(rng.integers(0, 99))}),
             int(rng.integers(1, 50))) for _ in range(n)]
    parts = []
    for k, v, _ts in rows:
        parts += [b"\x92", k, v]
    cursor = rng.bytes(int(rng.integers(1, 30))) if seed % 2 else None
    agg = {"sum": 3.5, "n": seed} if seed >= 2 else None
    for m in (jscan, tscan):
        assert m.pack_chunk(parts, n, cursor, n * 3, agg, seed >= 2) == \
            jscan.pack_chunk(parts, n, cursor, n * 3, agg, seed >= 2)
    spec = tquery.pack_spec(["cmp", "v", "<", 50], None)
    args = ("c", cursor, b"\xa4k0", -1 if seed % 2 else 7, bool(seed % 3),
            seed * 11, 4096, spec if seed else None,
            [[1, 2.5]] if seed >= 2 else None)
    assert tscan.encode_cursor(*args) == jscan.encode_cursor(*args)
    assert list(tscan.iter_winners(list(rows))) == \
        list(jscan.iter_winners(list(rows)))
    resp = ["response", "scan", [[k, v, ts] for k, v, ts in rows], True,
            b"cov", 9, 99, None]
    assert tscan._scan_result(resp) == jscan._scan_result(resp)
    assert tscan._scan_result(resp[:4]) == jscan._scan_result(resp[:4])
    assert tscan._mp_array_header(n * 997) == jscan._mp_array_header(n * 997)
    w, a = tquery.build_spec(["cmp", "v", ">=", seed], None)
    for mode in ("drop", "mark"):
        assert tscan.pack_peer_spec_cached(spec, w, a, mode) == \
            jscan.pack_peer_spec_cached(spec, w, a, mode)


@pytest.mark.parametrize("mint,read", [("ref", "port"), ("port", "ref")])
def test_cursor_minted_by_one_package_decodes_in_the_other(mint, read):
    """Equal decoded dicts; a foreign version or shape raises
    BadFieldType in both."""
    src, dst = PKGS[mint].scan, PKGS[read].scan
    spec = tquery.pack_spec(None, {"op": "sum", "field": "v", "group": 0})
    raw = src.encode_cursor("col", b"\xa5key01", None, -1, False, 42, 0,
                            spec, [[7, 1.5]])
    assert dst.decode_cursor(raw) == src.decode_cursor(raw)
    wire = codec.unpackb(src.encode_cursor("c", None, None, 5, True, 0, 0))
    wire[0] = "s1"
    for m in (src, dst):
        with pytest.raises(PKGS[read if m is dst else mint]
                           .errors.BadFieldType):
            m.decode_cursor(codec.packb(wire))


# ---------------------------------------------------------------------
# Scan plane: the coordinator over RF 1 and RF 3 stubs
# ---------------------------------------------------------------------


@pytest.mark.parametrize("rf", [1, 3])
def test_scan_chunks_equal_and_match_the_oracle(tmp_path, clocked, rf):
    """A byte-budgeted scan resumed chunk by chunk: byte-equal chunks,
    entries equal to the newest-wins oracle (stale replica and newer
    tombstones included), and equal to one big-budget scan."""
    chunks, oracle, stats = _scan_both(
        tmp_path / "small", rf, {"collection": "c", "max_bytes": 3000})
    assert len(chunks) > 3
    assert _entries(chunks) == oracle
    whole, _, _ = _scan_both(tmp_path / "big", rf,
                             {"collection": "c", "max_bytes": 16 << 20})
    assert _entries(whole) == _entries(chunks)
    assert stats["cursor_resumes"] == len(chunks) - 1


@pytest.mark.parametrize("rf", [1, 3])
def test_scan_limit_and_prefix_agree(tmp_path, clocked, rf):
    """limit: the first 37 oracle rows; prefix: the oracle rows under a
    raw encoded-key prefix — byte-equal chunks in both packages."""
    chunks, oracle, _ = _scan_both(
        tmp_path / "lim", rf, {"collection": "c", "limit": 37,
                               "max_bytes": 1500})
    assert _entries(chunks) == oracle[:37]
    prefix = codec.packb("doc-00123")[:8]
    chunks, oracle, _ = _scan_both(
        tmp_path / "pre", rf, {"collection": "c", "prefix": prefix})
    assert _entries(chunks) == [r for r in oracle if r[0].startswith(prefix)]


@pytest.mark.parametrize("rf", [1, 3])
def test_scan_count_and_filtered_aggregate_agree(tmp_path, clocked, rf):
    """count mode's running count ends at the oracle's live rows; a
    filtered scan and a
    grouped sum with a filter equal the oracle's (floating sums within
    the reference's own 1e-9 relative tolerance)."""
    chunks, oracle, _ = _scan_both(
        tmp_path / "cnt", rf, {"collection": "c", "count": True,
                               "max_bytes": 2000})
    counts = [codec.unpackb(p)["count"] for p in chunks]
    assert len(counts) > 1 and counts == sorted(counts)
    assert counts[-1] == len(oracle)
    docs = {k: codec.unpackb(v) for k, v in oracle}
    where = ["and", ["cmp", "v", "<", 400], ["cmp", "city", "!=", "new"]]
    spec = tquery.pack_spec(*tquery.build_spec(where, None))
    chunks, _, stats = _scan_both(tmp_path / "flt", rf,
                                  {"collection": "c", "spec": spec,
                                   "max_bytes": 2500})
    want = [(k, v) for k, v in oracle
            if docs[k]["v"] < 400 and docs[k]["city"] != "new"]
    assert _entries(chunks) == want
    assert stats["filter"]["rows_returned"] == len(want)
    spec = tquery.pack_spec(*tquery.build_spec(
        ["cmp", "city", "!=", "new"], {"op": "avg", "field": "v"}))
    chunks, _, _ = _scan_both(tmp_path / "agg", rf,
                              {"collection": "c", "spec": spec})
    got = codec.unpackb(chunks[-1])["agg"]
    vals = [d["v"] for d in docs.values() if d["city"] != "new"]
    assert got == pytest.approx(sum(vals) / len(vals), rel=1e-9)


@pytest.mark.parametrize("how", ["hard", "concurrency"])
def test_scan_sheds_equal(tmp_path, clocked, how):
    """The governor at LEVEL_HARD, or a plane already at
    scan_max_concurrent: the chunk raises each package's Overloaded
    with the same message, and the shed counters agree."""
    writes, _ = _replica_writes(2, 50, 1)
    got = {}
    for pkg in ("ref", "port"):
        m = PKGS[pkg]

        async def main():
            coord, stubs = await _cluster(pkg, str(tmp_path), 1, writes)
            plane = coord.scan_plane
            if how == "hard":
                coord.governor.force_level(m.governor.LEVEL_HARD)
            else:
                plane.active_scans = coord.config.scan_max_concurrent
            with pytest.raises(m.errors.Overloaded) as e:
                await plane.handle({"collection": "c"}, "scan")
            _close(stubs)
            return str(e.value), plane.stats(), coord.qos.stats()

        got[pkg] = run(main())
    assert got["port"] == got["ref"]
    assert got["port"][1]["sheds"] == 1


# ---------------------------------------------------------------------
# Watch plane
# ---------------------------------------------------------------------


def test_watch_cursor_codec_and_spec_where_agree():
    """Equal cursor bytes and decodes both ways; equal _spec_where
    results, and equal BadFieldType messages for a spec carrying an
    aggregate."""
    groups = []
    for i in range(3):
        g = twatch._FeedGroup("s%d" % i, [[i, i + 10], [100, 5]], None)
        g.boot, g.seq, g.flag_until, g.flag_ts = 17, 40 + i, 3, 99
        g.catchup = [1, b"\xa3abc", 17, 5] if i == 1 else None
        groups.append(g)
    spec = tquery.pack_spec(["prefix", "$key", b"\xa4"], None)
    raw = twatch.encode_cursor("c", spec, 3, "sub", groups)
    assert raw == jwatch.encode_cursor("c", spec, 3, "sub", groups)
    assert twatch.decode_cursor(raw) == jwatch.decode_cursor(raw)
    for where in (["cmp", "v", "<", 3], ["range", "v", 1, 9],
                  ["or", ["cmp", "city", "==", "a"],
                   ["prefix", "$key", b"\xa4d"]]):
        s = tquery.pack_spec(where, None)
        assert twatch._spec_where(s) == jwatch._spec_where(s)
    bad = tquery.pack_spec(None, {"op": "count"})
    msgs = []
    for m in (twatch, jwatch):
        with pytest.raises(Exception) as e:
            m._spec_where(bad)
        msgs.append((type(e.value).__name__, str(e.value)))
    assert msgs[0] == msgs[1]


async def _watch_chunks(pkg, d, rf, writes, writes_after, cfg_kw):
    coord, stubs = await _cluster(pkg, d, rf, writes, **cfg_kw)
    plane = coord.watch_plane
    tree = coord.collections["c"].tree
    first = await plane.handle({"collection": "c", "sub_id": "sub1"},
                               "watch")
    payloads = [first]
    for key, value, ts in writes_after:
        if value == b"":
            await tree.delete_with_timestamp(key, ts)
        else:
            await tree.set_with_timestamp(key, value, ts)
    cur = codec.unpackb(first)["cursor"]
    for _ in range(6):
        p = await plane.handle({"cursor": cur}, "watch_next")
        payloads.append(p)
        cur = codec.unpackb(p)["cursor"]
    _close(stubs)
    return payloads, plane.stats()


def _watch_both(tmp_path, rf, writes_after, **cfg_kw):
    writes, _ = _replica_writes(6, 120, rf)
    out = {}
    for pkg in ("ref", "port"):
        out[pkg] = run(_watch_chunks(pkg, str(tmp_path), rf, writes,
                                     writes_after, cfg_kw), timeout=60)
    assert out["port"] == out["ref"]  # byte-equal chunks, equal stats
    return out["port"]


def _fresh_writes(n, seed=9):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        key = codec.packb("w-%04d" % int(rng.integers(0, n // 2 + 1)))
        value = b"" if rng.random() < 0.1 else codec.packb({"i": i})
        out.append((key, value, NOW_NS + i))
    return out


@pytest.mark.parametrize("rf", [1, 3])
def test_watch_on_commit_events_give_equal_chunks(tmp_path, clocked, rf):
    """Writes after the first chunk reach the ring through on_commit:
    byte-equal chunks in both packages, the newest event of each key
    delivered, none dup-flagged."""
    writes = _fresh_writes(60)
    payloads, stats = _watch_both(tmp_path, rf, writes)
    events = [e for p in payloads for e in codec.unpackb(p)["events"]]
    newest = {}
    for key, value, ts in writes:
        newest[key] = (value, ts)
    got = {bytes(e[0]): (bytes(e[1]), e[2]) for e in events}
    assert got == newest
    assert all(e[3] == 0 for e in events)
    assert stats["catchup_replays"] == 0


def test_watch_stale_epoch_refuses_as_not_owned(tmp_path, clocked):
    """A cursor minted at epoch 1, resumed at epoch 2 mid-migration:
    KeyNotOwnedByShard with equal messages and fence counters."""
    writes, _ = _replica_writes(7, 30, 1)
    got = {}
    for pkg in ("ref", "port"):
        m = PKGS[pkg]

        async def main():
            coord, stubs = await _cluster(pkg, str(tmp_path), 1, writes)
            plane = coord.watch_plane
            first = await plane.handle({"collection": "c",
                                        "sub_id": "s"}, "watch")
            coord.membership_epoch = 2
            coord._migration_tasks.add(object())
            with pytest.raises(m.errors.KeyNotOwnedByShard) as e:
                await plane.handle(
                    {"cursor": codec.unpackb(first)["cursor"]},
                    "watch_next")
            _close(stubs)
            return (str(e.value), coord.fence_refusals,
                    plane.stats()["fence_refusals"])

        got[pkg] = run(main())
    assert got["port"] == got["ref"]
    assert got["port"][1:] == (1, 1)


@pytest.mark.parametrize("rf", [1, 3])
def test_watch_cursor_behind_the_ring_catches_up_flagged(tmp_path, clocked,
                                                         rf):
    """A 16-event ring overrun by 80 writes: the cursor falls behind,
    the plane catches up from durable state (the SCAN pages of the
    stub) with every replayed event FLAG_DUP — byte-equal chunks, and
    every key's newest state delivered."""
    writes = _fresh_writes(80, seed=10)
    payloads, stats = _watch_both(tmp_path, rf, writes, watch_ring=16)
    events = [e for p in payloads for e in codec.unpackb(p)["events"]]
    assert stats["catchup_replays"] >= 1 and stats["dup_flagged"] > 0
    assert any(e[3] & twatch.FLAG_DUP for e in events)
    newest = {}
    for key, value, ts in writes:
        newest[key] = (value, ts)
    got = {}
    for e in events:
        cur = got.get(bytes(e[0]))
        if cur is None or e[2] >= cur[1]:
            got[bytes(e[0])] = (bytes(e[1]), e[2])
    for key, (value, ts) in newest.items():
        if value != b"":  # durable-state catch-up carries live keys
            assert got[key] == (value, ts)
