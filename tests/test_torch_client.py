"""dbeel_tpu_torch.client — the async client — against dbeel_tpu's.

* Frames: both packages' ``DbeelClient``s run one call sequence against
  a recording stub server (port 0, canned answers, errors on chosen keys
  so the replica walk, the resync and the split of an oversized batch
  run).  The frames each one sends are byte-equal, step by step, with
  the per-call ``deadline_ms`` masked by name; the sequence sends every
  request type the reference client's source names.
* Routing: the ring each client builds from the same metadata, the
  replicas of seeded keys of every kind, and the backoff sequence of
  seeded ``_rng``s are equal.
* The client x node matrix: {reference, port} client x {reference,
  port} node (tests/torch_shards.py ``Node``, the port's on the CPU)
  run the same seeded operations with the same answers and error kinds.
"""

import ast
import asyncio
import collections
import random
import struct

import msgpack
import numpy as np
import pytest

from dbeel_tpu import client as jclient
from dbeel_tpu import errors as jerrors
from dbeel_tpu.cluster import messages as jmsgs
from dbeel_tpu.utils.murmur import hash_bytes as jhash_bytes
from dbeel_tpu.utils.murmur import hash_string
from dbeel_tpu_torch import client as tclient
from dbeel_tpu_torch import errors as terrors
from dbeel_tpu_torch.cluster import messages as tmsgs
from dbeel_tpu_torch.utils.murmur import hash_bytes as thash_bytes

from torch_shards import Node, no_leftovers, node_config, run  # noqa: F401

CLIENTS = {"ref": jclient, "port": tclient}
MSGS = {"ref": jmsgs, "port": tmsgs}
MASKED = ("deadline_ms",)


def _pack(obj) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


# ---------------------------------------------------------------------
# The request types a client's source sends
# ---------------------------------------------------------------------


def request_types(module) -> set:
    """Every string a client's source puts under a request's "type":
    dict literals' values, both arms of a conditional, and the strings
    assigned to a name used there (``rtype``)."""
    tree = ast.parse(open(module.__file__).read())
    names, types = set(), set()

    def strings(node):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return {node.value}
        if isinstance(node, ast.IfExp):
            return strings(node.body) | strings(node.orelse)
        if isinstance(node, ast.Name):
            names.add(node.id)
        return set()

    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "type":
                    types |= strings(v)
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id in names
                for t in node.targets):
            types |= strings(node.value)
    return types


def test_port_sends_the_reference_request_types():
    ref = request_types(jclient)
    assert ref == request_types(tclient)
    assert {"get_cluster_metadata", "create_collection", "drop_collection",
            "get_stats", "trace_dump", "cluster_stats", "telemetry_dump",
            "rearm", "set", "get", "delete", "cas", "atomic_batch", "scan",
            "scan_next", "watch", "watch_next", "multi_set",
            "multi_get"} == ref


# ---------------------------------------------------------------------
# Frames: a recording stub server with canned answers
# ---------------------------------------------------------------------

OK = _pack("OK") + b"\x02"
W_CURSOR = _pack(["w1", 0, 0, 3, 0, [["n0-0", 0, 1, 5]]])


def _ok(obj) -> bytes:
    return _pack(obj) + b"\x01"


def _err(kind, msg="stub") -> bytes:
    return _pack([kind, msg]) + b"\x00"


def stub_metadata(port):
    """Two nodes on the stub's one port (the walk crosses nodes, every
    frame lands here): n0 with the legacy token, n1 with two vnode
    tokens; collection "c" at RF 2; membership epoch 3."""
    nodes = [
        jmsgs.NodeMetadata(name="n0", ip="127.0.0.1",
                           remote_shard_base_port=9, ids=[0],
                           gossip_port=9, db_port=port),
        jmsgs.NodeMetadata(name="n1", ip="127.0.0.1",
                           remote_shard_base_port=9, ids=[0],
                           gossip_port=9, db_port=port,
                           tokens=[[hash_string("t-a"), hash_string("t-b")]]),
    ]
    return jmsgs.ClusterMetadata(nodes, [("c", 2), ("one", 1)], 3)


class Stub:
    """Records every request frame (u16-LE length + body) in arrival
    order and answers it by its type; keys named in ``answer`` fail the
    first time they are seen."""

    def __init__(self):
        self.frames = []
        self.seen = collections.Counter()
        self.server = None
        self.port = None

    async def start(self):
        self.server = await asyncio.start_server(self._serve, "127.0.0.1", 0)
        self.port = self.server.sockets[0].getsockname()[1]
        self.meta = _ok(stub_metadata(self.port).to_wire())
        return self

    async def stop(self):
        self.server.close()
        await self.server.wait_closed()

    async def _serve(self, reader, writer):
        try:
            while True:
                head = await reader.readexactly(2)
                body = await reader.readexactly(struct.unpack("<H", head)[0])
                self.frames.append(head + body)
                req = msgpack.unpackb(body, raw=False)
                payload = self.answer(req)
                writer.write(struct.pack("<I", len(payload)) + payload)
                await writer.drain()
                if not req.get("keepalive"):
                    break
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    def answer(self, req):
        t, key = req["type"], req.get("key")
        self.seen[(t, repr(key))] += 1
        first = self.seen[(t, repr(key))] == 1
        if t == "get_cluster_metadata":
            return self.meta
        if key == "shed" and first:
            return _err("Overloaded")
        if key == "moved" and first:
            return _err("KeyNotOwnedByShard")
        if key in ("missing", "ctr") and t == "get" and (
                key == "missing" or first):
            return _err("KeyNotFound")
        if t in ("cas", "atomic_batch"):
            if key == "conflict" or (key == "ctr" and first):
                return _err("CasConflict")
            return _ok({"ts": 1234})
        if t == "get":
            return _ok({"doc": key})
        if t in ("multi_set", "multi_get"):
            res = []
            for op in req["ops"]:
                if op[0] == "missing":
                    res.append([1, ["KeyNotFound", "stub"]])
                elif op[0] == "moved" and self.seen[("m", "moved")] == 0:
                    self.seen[("m", "moved")] += 1
                    res.append([1, ["KeyNotOwnedByShard", "stub"]])
                else:
                    res.append([0, _pack({"doc": op[0]})])
            return _ok(res)
        if t == "scan":
            if req.get("count"):
                return _ok({"entries": [], "cursor": None, "count": 42})
            if "spec" in req and "limit" not in req and not req.get("prefix"):
                return _ok({"entries": [], "cursor": None, "count": 0,
                            "agg": 99})
            return _ok({"entries": [["k1", {"v": 1}]], "cursor": b"c1",
                        "count": 1})
        if t == "scan_next":
            return _ok({"entries": [["k2", {"v": 2}]], "cursor": None,
                        "count": 2})
        if t in ("watch", "watch_next"):
            return _ok({"events": [[_pack("w1"), _pack({"v": 1}), 11, 0],
                                   [_pack("w2"), b"", 12, 1]],
                        "cursor": W_CURSOR})
        if t in ("get_stats", "trace_dump", "cluster_stats",
                 "telemetry_dump"):
            return _ok({"type": t, "shard": "stub-0"})
        return OK


def mask(frame: bytes, names=MASKED) -> bytes:
    """``frame``'s body with the value after each map key of ``names``
    replaced by nil (its length prefix checked first)."""
    (n,) = struct.unpack("<H", frame[:2])
    body = frame[2:]
    assert n == len(body)
    for name in names:
        key = _pack(name)
        pos = body.find(key)
        while pos >= 0:
            start = pos + len(key)
            unpacker = msgpack.Unpacker(raw=False)
            unpacker.feed(body[start:])
            unpacker.unpack()
            body = body[:start] + b"\xc0" + body[start + unpacker.tell():]
            pos = body.find(key, start + 1)
    return body


async def _outcome(coro):
    try:
        return ("ok", await coro)
    except Exception as e:  # noqa: BLE001 — the kind is the outcome
        return ("err", type(e).__name__)


async def _agen_first(agen):
    try:
        return await agen.__anext__()
    finally:
        await agen.aclose()


def _sync_calls(cm, addr):
    """The Sync* wrappers, in a thread of their own (their own loop)."""
    s = cm.DbeelClientSync([addr])
    try:
        col = s.create_collection("c", 2)
        out = [s.get_stats(), s.cluster_stats(), s.telemetry_dump(),
               s.rearm(), col.set("s1", 1), col.get("s1"),
               col.cas("s1", 2, expect_ts=1), col.atomic_batch(
                   [{"key": "s1", "value": 3}]),
               col.rmw("s2", lambda v: [v]), col.scan(filter=["cmp", "v",
                                                              ">", 0]),
               col.count(), col.delete("s1")]
        w = col.watcher(wait_ms=7, sub_id="x")
        out += [w.next_events(), w.cursor, w.events_seen, w.dup_flagged,
                w.monotonicity_violations]
        s.drop_collection("c")
        s.collection("one")
        s._client.close()
        s._run(asyncio.sleep(0))
        return out
    finally:
        s.close()


def call_steps(cm, addr, client_kw):
    """(name, async step(client) -> outcome) in the order they run."""
    C = cm.Consistency

    async def boot(c):
        return await c.create_collection(
            "c", replication_factor=2, ops_per_sec=5, bytes_per_sec=6,
            index=["v", "w"])

    async def scan_all(col, **kw):
        return [kv async for kv in col.scan(**kw)]

    async def watcher(col):
        w = col.watcher(filter=["cmp", "v", ">=", 1], wait_ms=5,
                        sub_id="sub")
        a = await w.next_events()
        b = await w.next_events()
        resumed = col.watcher(cursor=w.cursor, wait_ms=0)
        c = await resumed.next_events()
        return a, b, c, w.cursor, w.chunks, w.events_seen, w.dup_flagged

    def col(c):
        return c.collection("c")

    return [
        ("create_collection", boot),
        ("collections", lambda c: _outcome(c.drop_collection("gone"))),
        ("metadata", lambda c: c.get_cluster_metadata()),
        ("admin", lambda c: asyncio.gather(
            c.get_stats(), c.trace_dump(), c.cluster_stats(),
            c.telemetry_dump(), c.rearm(),
            c.get_stats("127.0.0.1", addr[1]))),
        ("set", lambda c: col(c).set("k1", {"v": 1})),
        ("set_levels", lambda c: asyncio.gather(*(
            col(c).set(f"l{i}", i, consistency=lvl, trace_id=i + 1)
            for i, lvl in enumerate((C.fixed(1), C.QUORUM, C.ALL))))),
        ("get", lambda c: col(c).get("k1", consistency=C.QUORUM,
                                     trace_id=3)),
        ("get_missing", lambda c: _outcome(col(c).get("missing"))),
        ("walk_past_overloaded", lambda c: col(c).set("shed", 1)),
        ("resync_not_owned", lambda c: col(c).set("moved", [1, 2.5])),
        ("delete", lambda c: col(c).delete("k1", consistency=C.ALL,
                                           trace_id=4)),
        ("key_kinds", lambda c: asyncio.gather(*(
            col(c).get(k) for k in (7, -3, 2.5, b"\x00\xff", (1, "a"),
                                    "é" * 40)))),
        ("multi_set", lambda c: col(c).multi_set(
            {f"m{i}": {"v": i} for i in range(40)}, consistency=C.QUORUM,
            trace_id=5)),
        ("multi_set_split", lambda c: col(c).multi_set(
            [(f"big{i}", "x" * 30000) for i in range(3)])),
        ("multi_get", lambda c: col(c).multi_get(
            ["m1", "missing", "moved", "m2"], consistency=C.fixed(1))),
        ("scan", lambda c: scan_all(
            col(c), prefix=b"\xa2m", limit=10, max_bytes=100,
            filter=["cmp", "v", "<", 3], trace_id=6)),
        ("count", lambda c: asyncio.gather(
            col(c).count(), col(c).count(filter=["cmp", "v", "<", 3]),
            col(c).count(aggregate={"op": "sum", "field": "v"}),
            col(c).count(prefix=b"\xa2", limit=5))),
        ("count_limit_aggregate", lambda c: _outcome(col(c).count(
            limit=5, aggregate={"op": "sum", "field": "v"}))),
        ("cas", lambda c: asyncio.gather(
            col(c).cas("k2", 1, expect_ts=5),
            col(c).cas("k3", delete=True, expect_value={"a": 1}),
            col(c).cas("k4", [1], expect_absent=True, trace_id=8,
                       consistency=C.ALL))),
        ("cas_conflict", lambda c: _outcome(col(c).cas(
            "conflict", 1, expect_absent=True))),
        ("rmw", lambda c: col(c).rmw("ctr", lambda v: [v])),
        ("atomic_batch", lambda c: col(c).atomic_batch(
            [{"key": "a", "value": 1},
             {"key": "b", "delete": True, "expect_ts": 3}],
            consistency=C.QUORUM, trace_id=9)),
        ("atomic_batch_refused", lambda c: asyncio.gather(
            _outcome(col(c).atomic_batch([])),
            _outcome(col(c).atomic_batch([{"value": 1}])))),
        ("watcher", lambda c: watcher(col(c))),
        ("watch", lambda c: _agen_first(col(c).watch(wait_ms=5))),
        ("qos", lambda c: _qos(cm, addr, client_kw)),
        ("sync", lambda c: asyncio.to_thread(_sync_calls, cm, addr)),
    ]


async def _qos(cm, addr, client_kw):
    c = await cm.DbeelClient.from_seed_nodes(
        [addr], qos_class="batch", tenant="t1", **client_kw)
    try:
        col = c.collection("c")
        await col.set("q", 1)
        return await asyncio.gather(
            col.get("q"), col.multi_get(["q"]), col.count())
    finally:
        c.close()


async def _record(pkg, client_kw):
    cm = CLIENTS[pkg]
    stub = await Stub().start()
    addr = ("127.0.0.1", stub.port)
    c = await cm.DbeelClient.from_seed_nodes([addr], **client_kw)
    c._rng = random.Random(18)
    got = {"boot": [mask(f) for f in stub.frames]}
    answers = {}
    try:
        for name, step in call_steps(cm, addr, client_kw):
            n = len(stub.frames)
            out = await step(c)
            if name == "create_collection":
                out = (out.name, out.replication_factor)
            elif name == "metadata":
                # The stub's port is in it: the node count stays.
                out = (len(out.nodes), out.collections, out.epoch)
            answers[name] = repr(out)
            got[name] = sorted(mask(f) for f in stub.frames[n:])
    finally:
        c.close()
        await stub.stop()
    return got, answers


MODES = {"pooled": {}, "one_shot": {"pooled": False},
         "pipelined": {"pipeline_window": 4}}


@pytest.mark.parametrize("mode", list(MODES))
def test_frames_byte_equal(mode):
    ref = run(_record("ref", MODES[mode]), timeout=30)
    port = run(_record("port", MODES[mode]), timeout=30)
    assert list(ref[0]) == list(port[0])
    for name in ref[0]:
        assert ref[0][name] == port[0][name], name
    assert ref[1] == port[1]
    types = set()
    for frames in port[0].values():
        types |= {msgpack.unpackb(f, raw=False)["type"] for f in frames}
    assert request_types(jclient) <= types
    # The walk and the resync ran: replica 1 after the shed, a metadata
    # resync after the not-owned answer, the oversized batch split.
    assert len(port[0]["walk_past_overloaded"]) == 2
    assert len(port[0]["resync_not_owned"]) == 3
    assert len(port[0]["multi_set_split"]) == 2
    assert port[1]["cas_conflict"] == "('err', 'CasConflict')"
    assert port[1]["count_limit_aggregate"] == "('err', 'BadFieldType')"


# ---------------------------------------------------------------------
# Routing and backoff
# ---------------------------------------------------------------------


def _seeded_keys(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = i % 7
        if kind == 0:
            out.append(rng.bytes(int(rng.integers(1, 40))).hex())
        elif kind == 1:
            out.append(int(rng.integers(0, 1 << 62)) >> int(
                rng.integers(0, 62)))
        elif kind == 2:
            out.append(-int(rng.integers(1, 1 << 62)) >> int(
                rng.integers(0, 62)))
        elif kind == 3:
            out.append(float(rng.standard_normal() * 10.0 ** int(
                rng.integers(-5, 12))))
        elif kind == 4:
            out.append(rng.bytes(int(rng.integers(0, 300))))
        elif kind == 5:
            out.append((int(rng.integers(-9, 9)), rng.bytes(3).hex()))
        else:
            out.append("k" * int(rng.integers(20, 300)))
    return out


def _metadata(pkg, n_nodes, vnodes):
    m = MSGS[pkg]
    nodes = []
    for i in range(n_nodes):
        tokens = None
        if vnodes and i % 2:
            tokens = [[hash_string(f"v{i}-{s}-{t}") for t in range(4)]
                      for s in range(2)]
        nodes.append(m.NodeMetadata(
            name=f"node{i}", ip=f"10.0.0.{i}", remote_shard_base_port=9,
            ids=[0, 1], gossip_port=9, db_port=4000 + 8 * i, tokens=tokens))
    return m.ClusterMetadata(nodes, [("c", 3)], 7)


@pytest.mark.parametrize("vnodes", [False, True])
def test_routing_equal_for_seeded_keys(vnodes):
    clients = {}
    for pkg, cm in CLIENTS.items():
        c = cm.DbeelClient([("127.0.0.1", 1)])
        c._apply_metadata(_metadata(pkg, 5, vnodes))
        clients[pkg] = c
    ring = {pkg: [(s.node_name, s.hash, s.ip, s.db_port) for s in c._ring]
            for pkg, c in clients.items()}
    assert ring["ref"] == ring["port"] and len(ring["port"]) >= 10
    assert clients["port"]._cluster_epoch == 7
    for key in _seeded_keys(3000, 18):
        h = jhash_bytes(_pack(key))
        assert thash_bytes(tclient.msgpack_codec.packb(key)) == h, key
        for rf in (1, 3):
            walks = {pkg: [(s.node_name, s.hash) for s in
                           c._shards_for_key(h, rf)]
                     for pkg, c in clients.items()}
            assert walks["ref"] == walks["port"], key
            assert len({n for n, _ in walks["port"]}) == rf


def test_empty_ring_refuses_alike():
    for cm, errors in ((jclient, jerrors), (tclient, terrors)):
        with pytest.raises(errors.ConnectionError_, match="empty ring"):
            cm.DbeelClient([("127.0.0.1", 1)])._shards_for_key(5, 1)


@pytest.mark.parametrize("seed", [0, 18, 99])
def test_backoff_sequences_equal(seed):
    seqs = {}
    for pkg, cm in CLIENTS.items():
        c = cm.DbeelClient([("127.0.0.1", 1)], op_deadline_s=0.2)
        c._rng = random.Random(seed)
        seqs[pkg] = ([c._backoff_s(a, c._rng) for a in range(40)],
                     c._retry_reserve_s())
    assert seqs["ref"] == seqs["port"]
    cap = tclient.DbeelClient.BACKOFF_CAP_S
    assert all(0 < d <= cap for d in seqs["port"][0])
    assert seqs["port"][1] == 0.05


def test_consistency_resolves_alike():
    for kind in ("fixed", "quorum", "all"):
        for rf in range(1, 6):
            got = []
            for cm in CLIENTS.values():
                c = {"fixed": cm.Consistency.fixed(2),
                     "quorum": cm.Consistency.QUORUM,
                     "all": cm.Consistency.ALL}[kind]
                got.append(cm.Consistency.resolve(c, rf))
            assert got[0] == got[1]


def test_pipelined_connection_fails_every_waiter():
    """A dropped pipelined connection fails every request in flight
    with ConnectionError_, and the connection is unusable after."""

    async def main(cm):
        async def serve(reader, writer):
            await reader.readexactly(2)
            writer.close()

        server = await asyncio.start_server(serve, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        pipe = cm._PipelinedConnection("127.0.0.1", port, 8)
        outs = await asyncio.gather(
            *(_outcome(pipe.request(_pack({"type": "get", "i": i})))
              for i in range(4)))
        usable = pipe.usable
        pipe.close()
        server.close()
        await server.wait_closed()
        return outs, usable

    ref, port = (run(main(cm)) for cm in (jclient, tclient))
    assert ref == port
    assert port[0] == [("err", terrors.ConnectionError_.__name__)] * 4
    assert not port[1]


# ---------------------------------------------------------------------
# The client x node matrix
# ---------------------------------------------------------------------

_RNG = np.random.default_rng(18)
DOCS = {f"doc{i:03d}": {"v": int(_RNG.integers(0, 1000)),
                        "s": _RNG.bytes(int(_RNG.integers(0, 12))).hex()}
        for i in range(120)}


def _same_arc(node, n):
    """``n`` keys on one arc of the node's ring (an atomic batch)."""
    tokens = sorted(s.hash for s in node.shards[0].shards)

    def arc(key):
        h = jhash_bytes(_pack(key))
        return sum(t < h for t in tokens) % len(tokens)

    keys = [f"arc{i}" for i in range(64)]
    return [k for k in keys if arc(k) == arc(keys[0])][:n]


async def _drain(w, want, rounds=200):
    """Chunks until every key of ``want`` reached its value (the newest
    version per key arrives; a set and a delete may fold into one
    event): the state, sorted, and the flags seen."""
    got, flags = {}, set()
    for _ in range(rounds):
        for k, v, _ts, fl in await w.next_events():
            got[k] = v
            flags.add(fl)
        if all(k in got and got[k] == v for k, v in want.items()):
            break
    return sorted(got.items()), sorted(flags)


def _sync_ops(cm, addr):
    s = cm.DbeelClientSync([addr])
    try:
        col = s.collection("m")
        out = [col.set("sync", {"v": 1}), col.get("sync"),
               col.count(filter=["cmp", "v", "<", 10])]
        out.append(col.rmw("sync", lambda v: {"v": v["v"] + 1}))
        out.append(col.get("sync"))
        out.append(len(col.scan(limit=7)))
        col.delete("sync")
        try:
            col.get("sync")
        except Exception as e:  # noqa: BLE001
            out.append(type(e).__name__)
        w = col.watcher(wait_ms=0)
        out.append(w.next_events())
        out.append(s.get_stats()["collections"]["m"]["replication_factor"])
        s._client.close()
        s._run(asyncio.sleep(0))
        return out
    finally:
        s.close()


async def _matrix(client_pkg, node_pkg, d):
    cm = CLIENTS[client_pkg]
    C = cm.Consistency
    node = await Node(node_pkg, node_config(node_pkg, d), n_shards=2).start()
    c = None
    try:
        c = await cm.DbeelClient.from_seed_nodes([node.db_address])
        col = await c.create_collection("m", replication_factor=1)
        out = [await _outcome(c.create_collection("m"))]
        for i, lvl in enumerate((None, C.fixed(1), C.QUORUM, C.ALL)):
            out.append(await _outcome(col.set(f"c{i}", [i], consistency=lvl)))
            out.append(await _outcome(col.get(f"c{i}", consistency=lvl)))
        out.append(await _outcome(col.get("absent")))
        out.append(await _outcome(c.collection("nope").get("x")))
        await col.multi_set(DOCS)
        keys = list(DOCS)[::3] + ["absent"]
        out.append(await col.multi_get(keys))
        flt = ["and", ["cmp", "v", "<", 500], ["cmp", "v", ">=", 100]]
        out.append([kv async for kv in col.scan(filter=flt)])
        out.append([kv async for kv in col.scan(
            prefix=_pack("doc010")[:6], max_bytes=64)])
        out.append(await col.count(filter=flt))
        out.append(await col.count(
            aggregate={"op": "sum", "field": "v"}, filter=flt))
        out.append(await col.count(limit=5))
        out.append(await _outcome(col.cas("doc000", 1, expect_value="no")))
        out.append((await _outcome(col.cas(
            "doc000", 1, expect_value=DOCS["doc000"])))[0])
        out.append(await col.get("doc000"))
        for _ in range(3):
            out.append(await col.rmw("ctr", lambda v: (v or 0) + 1))
        a, b = _same_arc(node, 2)
        out.append((await _outcome(col.atomic_batch(
            [{"key": a, "value": 1},
             {"key": b, "value": 2, "expect_absent": True}])))[0])
        out.append(await _outcome(col.atomic_batch(
            [{"key": a, "value": 3, "expect_value": 2}])))
        out.append(await _outcome(col.atomic_batch(
            [{"key": f"x{i}", "value": i} for i in range(16)])))
        await col.delete("doc001")
        out.append(await _outcome(col.get("doc001")))
        w = col.watcher(wait_ms=20)
        await w.next_events()
        for i in range(6):
            await col.set(f"w{i}", {"v": i})
        await col.delete("w0")
        first = await _drain(w, {"w0": None, **{
            f"w{i}": {"v": i} for i in range(1, 6)}})
        cursor = w.cursor
        for i in range(6, 9):
            await col.set(f"w{i}", {"v": i})
        resumed = col.watcher(cursor=cursor, wait_ms=20)
        later = await _drain(resumed, {
            f"w{i}": {"v": i} for i in range(6, 9)})
        out.append((first, later, w.monotonicity_violations,
                    resumed.monotonicity_violations))
        out.append(await asyncio.to_thread(_sync_ops, cm, node.db_address))
        stats = await c.get_stats()
        out.append((stats["shard"], sorted(stats["collections"])))
        return out
    finally:
        if c is not None:
            c.close()
        await node.stop()


@pytest.mark.parametrize("client_pkg,node_pkg", [
    ("port", "port"), ("port", "ref"), ("ref", "port")])
def test_client_node_matrix(tmp_path, client_pkg, node_pkg):
    """Each combination answers as the reference client on a reference
    node does, and as the oracle says."""
    want = run(_matrix("ref", "ref", str(tmp_path / "ref")), timeout=60)
    port = run(_matrix(client_pkg, node_pkg, str(tmp_path / "combo")),
               timeout=60)
    assert port == want
    assert port[0] == ("err", "CollectionAlreadyExists")
    assert port[1:9] == [("ok", None), ("ok", [0]), ("ok", None),
                         ("ok", [1]), ("ok", None), ("ok", [2]),
                         ("ok", None), ("ok", [3])]
    assert port[9:11] == [("err", "KeyNotFound"),
                          ("err", "CollectionNotFound")]
    keys = list(DOCS)[::3]
    assert port[11] == [DOCS[k] for k in keys] + [None]
    flt_rows = sorted((k, v) for k, v in DOCS.items()
                      if 100 <= v["v"] < 500)
    assert port[12] == flt_rows
    assert port[13] == [(k, DOCS[k]) for k in sorted(DOCS)
                        if k.startswith("doc01")]
    assert port[14] == len(flt_rows)
    assert port[15] == sum(v["v"] for _k, v in flt_rows)
    assert port[16] == 5
    assert port[17] == ("err", "CasConflict")
    assert port[18:24] == ["ok", 1, 1, 2, 3, "ok"]
    assert port[24] == ("err", "CasConflict")
    assert port[25] == ("err", "BadFieldType")
    assert port[26] == ("err", "KeyNotFound")
    first, later, v1, v2 = port[27]
    assert first == ([("w0", None)] + [
        (f"w{i}", {"v": i}) for i in range(1, 6)], [0])
    # The resumed cursor delivers the later writes alone, once.
    assert later == ([(f"w{i}", {"v": i}) for i in range(6, 9)], [0])
    assert v1 == v2 == 0
    # v < 10: "sync", w1-w8 and the documents below 10.
    below = 9 + sum(d["v"] < 10 for d in DOCS.values())
    assert port[28] == [None, {"v": 1}, below, {"v": 2}, {"v": 2}, 7,
                        "KeyNotFound", [], 1]
