"""dbeel_tpu_torch.server.db_server — the document API a node serves —
against dbeel_tpu's, over real TCP.

Each package's node is built by its own ``run.create_shard`` and run by
its own ``run.run_shard`` (tests/torch_shards.py ``Node``; the port's
with ``device="cpu"``) on ports from ``port_block``.  The wire cases
send raw frames (u16-LE length + a msgpack map packed here) with no
client in between and compare the response bytes; where a response
carries a per-boot field (a decided timestamp, the watch cursor's
subscription id and boot epoch, stats stamps) it is decoded and that
field masked by name.  Equality is exact everywhere else."""

import asyncio
import os
import struct

import msgpack
import numpy as np
import pytest

from dbeel_tpu import errors as jerrors
from dbeel_tpu import query as jquery
from dbeel_tpu.client import Consistency, DbeelClient
from dbeel_tpu.flow_events import FlowEvent as JFlowEvent
from dbeel_tpu_torch.flow_events import FlowEvent as TFlowEvent

from torch_shards import (  # noqa: F401
    PER_BOOT,
    PKGS,
    Node,
    key_tree,
    mask,
    no_leftovers,
    node_config,
    port_block,
    run,
)

FLOW = {"ref": JFlowEvent, "port": TFlowEvent}


def frame(req) -> bytes:
    """One request frame: u16-LE length + the msgpack map (or raw
    bytes, for the malformed cases)."""
    body = req if isinstance(req, bytes) else msgpack.packb(
        req, use_bin_type=True)
    return struct.pack("<H", len(body)) + body


async def _read_response(reader) -> bytes:
    """One response: u32-LE length, then the payload and its type
    byte."""
    (n,) = struct.unpack("<I", await reader.readexactly(4))
    return await reader.readexactly(n)


async def exchange(port, reqs, n_responses=None):
    """Write every frame of ``reqs`` at once on one connection, read
    ``n_responses`` responses (all by default) in order, then whether
    the server closed the connection after them."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(b"".join(frame(r) for r in reqs))
        await writer.drain()
        n = len(reqs) if n_responses is None else n_responses
        out = [await _read_response(reader) for _ in range(n)]
        closed = False
        if not any(isinstance(r, dict) and r.get("keepalive")
                   for r in reqs[n - 1:n]):
            closed = await asyncio.wait_for(reader.read(1), 5) == b""
        return out, closed
    finally:
        writer.close()
        await writer.wait_closed()


def decode(resp: bytes):
    return resp[-1], msgpack.unpackb(resp[:-1], raw=False)


# ---------------------------------------------------------------------
# Wire parity: the same frames into a reference node and a port node
# ---------------------------------------------------------------------

_RNG = np.random.default_rng(17)
DOCS = [(f"k{i:02d}", {"v": int(_RNG.integers(0, 1000)),
                       "s": _RNG.bytes(int(_RNG.integers(0, 24))).hex()})
        for i in range(24)]
KEEP = {"keepalive": True}


def _set(key, value, **kw):
    return {"type": "set", "collection": "c", "key": key, "value": value,
            **kw}


def _get(key, **kw):
    return {"type": "get", "collection": "c", "key": key, **kw}


def _cursor(got, step):
    return decode(got[step][0][-1])[1]["cursor"]


# (name, frames or a function of the responses so far, how compared).
# "bytes": the response bytes; "ts": decoded, "ts" masked; "watch":
# decoded, the cursor and each event's stamp masked; "tree": the key
# tree of the decoded map, per-boot fields masked; "kind": the error
# kind only (the message is the decoder's own text, see the test).
STEPS = [
    ("metadata_empty", [{"type": "get_cluster_metadata"}], "bytes"),
    ("create_collection", [{"type": "create_collection", "name": "c"}],
     "bytes"),
    ("create_collection_again",
     [{"type": "create_collection", "name": "c"}], "bytes"),
    ("create_collection_ddl",
     [{"type": "create_collection", "name": "q", "replication_factor": 1,
       "ops_per_sec": 100000, "bytes_per_sec": 1 << 24, "index": ["v"]}],
     "bytes"),
    ("get_collection", [{"type": "get_collection", "name": "q"}], "bytes"),
    ("get_collection_plain", [{"type": "get_collection", "name": "c"}],
     "bytes"),
    ("metadata", [{"type": "get_cluster_metadata"}], "bytes"),
    ("watch", [{"type": "watch", "collection": "c", "wait_ms": 0}],
     "watch"),
    ("set", [_set(k, v) for k, v in DOCS[:8]], "bytes"),
    ("set_keepalive_pipelined",
     [_set(k, v, **KEEP) for k, v in DOCS[8:]], "bytes"),
    ("get", [_get(k) for k, _ in DOCS[:4]], "bytes"),
    ("get_batched",
     [_get(k, **KEEP) for k, _ in DOCS] + [_get("absent", **KEEP)],
     "bytes"),
    ("get_missing", [_get("absent")], "bytes"),
    ("one_shot_closes", [_get(DOCS[0][0]), _get(DOCS[1][0])], "bytes"),
    ("mixed_keepalive_then_close",
     [_set("mk", [1, 2], **KEEP), _get("mk", **KEEP), _get("mk"),
      _get("mk", **KEEP)], "bytes"),
    ("delete", [{"type": "delete", "collection": "c", "key": DOCS[1][0]}],
     "bytes"),
    ("get_deleted", [_get(DOCS[1][0])], "bytes"),
    ("multi_set",
     [{"type": "multi_set", "collection": "c",
       "ops": [[f"m{i}", None, {"i": i}] for i in range(6)] + [[5]]}],
     "bytes"),
    ("multi_get",
     [{"type": "multi_get", "collection": "c",
       "ops": [[f"m{i}", None] for i in range(6)] + [["nope", None], 7]}],
     "bytes"),
    ("cas", [{"type": "cas", "collection": "c", "key": DOCS[2][0],
              "value": "swapped", "expect_value": DOCS[2][1]}], "ts"),
    ("cas_conflict", [{"type": "cas", "collection": "c", "key": DOCS[2][0],
                       "value": "again", "expect_value": DOCS[2][1]}],
     "bytes"),
    ("cas_no_expectation", [{"type": "cas", "collection": "c",
                             "key": DOCS[3][0], "value": 1}], "bytes"),
    ("cas_absent", [{"type": "cas", "collection": "c", "key": "fresh",
                     "value": 1, "expect_absent": True}], "ts"),
    ("atomic_batch",
     [{"type": "atomic_batch", "collection": "c",
       "ops": [{"key": "a1", "value": 1},
               {"key": "a2", "value": 2, "expect_absent": True}]}], "ts"),
    ("atomic_batch_conflict",
     [{"type": "atomic_batch", "collection": "c",
       "ops": [{"key": "a1", "value": 3, "expect_value": 2}]}],
     "bytes"),
    ("atomic_batch_empty",
     [{"type": "atomic_batch", "collection": "c", "ops": []}], "bytes"),
    ("scan", [{"type": "scan", "collection": "c", "max_bytes": 64}],
     "bytes"),
    ("scan_next",
     lambda got: [{"type": "scan_next", "cursor": _cursor(got, "scan")}],
     "bytes"),
    ("scan_filtered",
     [{"type": "scan", "collection": "c",
       "spec": jquery.pack_spec(*jquery.build_spec(
           ["cmp", "v", "<", 500], None))}], "bytes"),
    ("watch_next",
     lambda got: [{"type": "watch_next", "cursor": _cursor(got, "watch"),
                   "wait_ms": 0}], "watch"),
    ("rearm", [{"type": "rearm"}], "bytes"),
    ("get_stats", [{"type": "get_stats"}], "tree"),
    ("cluster_stats", [{"type": "cluster_stats"}], "tree"),
    ("telemetry_dump", [{"type": "telemetry_dump"}], "tree"),
    ("trace_dump", [{"type": "trace_dump"}], "tree"),
    ("drop_collection", [{"type": "drop_collection", "name": "q"}],
     "bytes"),
    ("drop_collection_again", [{"type": "drop_collection", "name": "q"}],
     "bytes"),
    ("collection_not_found", [{"type": "get_collection", "name": "q"},
                              {"type": "get", "collection": "zz",
                               "key": "k"}], "bytes"),
    ("missing_field", [{"type": "set", "collection": "c", "value": 1},
                       {"type": "get", "key": "k"},
                       {"type": "create_collection"}], "bytes"),
    ("bad_field_type", [{"type": 5}, {"collection": "c"},
                        {"type": "multi_get", "collection": "c",
                         "ops": 5}], "bytes"),
    ("unknown_type", [{"type": "frobnicate"}], "bytes"),
    ("not_a_map", [msgpack.packb([1, 2]), msgpack.packb("set")], "bytes"),
    ("truncated_and_trailing", [b"\x92\x01", b"\x80\x01", b""], "bytes"),
    ("not_msgpack", [b"\xc1"], "kind"),
    ("deadline_expired", [_set("late", 1, deadline_ms=1)], "bytes"),
]


async def _scenario(pkg, d, base):
    """Run every step against one node of ``pkg``; returns
    {step: (responses, closed)}."""
    node = await Node(pkg, node_config(pkg, d, base)).start()
    got = {}
    try:
        for name, reqs, _how in STEPS:
            if callable(reqs):
                reqs = reqs(got)
            if name == "one_shot_closes":
                # The second frame rides behind a non-keepalive one:
                # the server answers the first and closes.
                got[name] = await exchange(node.config.port, reqs, 1)
            elif name == "mixed_keepalive_then_close":
                got[name] = await exchange(node.config.port, reqs, 3)
            elif any(isinstance(r, dict) and r.get("keepalive")
                     for r in reqs):
                got[name] = await exchange(node.config.port, reqs)
            else:
                out = [await exchange(node.config.port, [r]) for r in reqs]
                got[name] = ([o[0][0] for o in out], all(o[1] for o in out))
    finally:
        await node.stop()
    return got


@pytest.fixture(scope="module")
def wire(tmp_path_factory):
    """Both packages' answers to STEPS, one node after the other on the
    same block of ports (so metadata names the same ports)."""
    d = tmp_path_factory.mktemp("wire")
    base = port_block()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DBEEL_NO_DATAPLANE", "1")
        mp.setenv("DBEEL_NO_QF", "1")
        return {pkg: run(_scenario(pkg, str(d / pkg), base), timeout=30)
                for pkg in ("ref", "port")}


def _masked(resp, how):
    t, body = decode(resp)
    if how == "ts":
        return t, mask(body, ("ts",))
    if how == "watch":
        # A watch chunk's cursor holds the subscription id and the
        # ring's boot epoch, and each event [key, value, ts, flags]
        # its write stamp: per-boot, masked by name.
        events = [[e[0], e[1], "ts", e[3]] for e in body["events"]]
        return t, {**mask(body, ("cursor",)), "events": events}
    stats = mask(body, PER_BOOT)
    if isinstance(stats, dict):
        # The port's one get_stats key beyond the reference's (each
        # collection's merge and device), and the coalescer block,
        # whose shape depends on which package's coalescer this
        # process imported: their values are checked below.
        for col in stats.get("collections", {}).values():
            col.pop("strategy", None)
        stats.pop("device_coalescer", None)
    return t, key_tree(stats)


@pytest.mark.parametrize("step", [s[0] for s in STEPS])
def test_wire_parity(wire, step):
    how = dict((s[0], s[2]) for s in STEPS)[step]
    ref, port = wire["ref"][step], wire["port"][step]
    assert len(ref[0]) == len(port[0]) and ref[1] == port[1]
    if how == "bytes":
        assert ref == port
    elif how == "kind":
        # The reference's decoder reports b"\xc1" with an empty message
        # ("document: "), the port's codec names the byte ("document:
        # Unpack failed: invalid type 0xc1"); the kind is the contract.
        (tr, er), (tp, ep) = decode(ref[0][0]), decode(port[0][0])
        assert (tr, er[0]) == (tp, ep[0]) == (0, "BadFieldType")
        assert er[1].startswith("document:") and ep[1].startswith(
            "document:")
    else:
        assert [_masked(r, how) for r in ref[0]] == [
            _masked(r, how) for r in port[0]]


def test_wire_parity_covers_every_request_type():
    """Every client request type of handle_request is sent by STEPS."""
    stub = {name: ([msgpack.packb({"cursor": b""}) + b"\x01"], True)
            for name, _reqs, _how in STEPS}
    sent = set()
    for _name, reqs, _how in STEPS:
        reqs = reqs(stub) if callable(reqs) else reqs
        sent |= {r.get("type") for r in reqs if isinstance(r, dict)}
    assert {"create_collection", "get_collection", "drop_collection",
            "get_cluster_metadata", "get_stats", "cluster_stats", "set",
            "delete", "get", "multi_set", "multi_get", "cas",
            "atomic_batch", "scan", "scan_next", "watch", "watch_next",
            "rearm", "telemetry_dump", "trace_dump"} <= sent


def test_wire_answers_are_the_expected_ones(wire):
    """What the port answered, not only that it equals the reference:
    values, misses, the one-shot close and the error kinds."""
    got = wire["port"]
    assert [decode(r) for r in got["get"][0]] == [
        (1, v) for _k, v in DOCS[:4]]
    assert [decode(r) for r in got["get_batched"][0]] == [
        (1, v) for _k, v in DOCS] + [(0, ["KeyNotFound", repr(
            msgpack.packb("absent", use_bin_type=True))])]
    assert decode(got["get_deleted"][0][0])[1][0] == "KeyNotFound"
    assert got["one_shot_closes"][1] and len(got["one_shot_closes"][0]) == 1
    kinds = {name: [decode(r)[1][0] for r in got[name][0]] for name in (
        "missing_field", "bad_field_type", "unknown_type", "not_a_map",
        "collection_not_found", "create_collection_again",
        "deadline_expired", "cas_conflict", "atomic_batch_conflict")}
    assert kinds == {
        "missing_field": ["MissingField"] * 3,
        "bad_field_type": ["BadFieldType"] * 3,
        "unknown_type": ["UnsupportedField"],
        "not_a_map": ["BadFieldType"] * 2,
        "collection_not_found": ["CollectionNotFound"] * 2,
        "create_collection_again": ["CollectionAlreadyExists"],
        "deadline_expired": ["Overloaded"],
        "cas_conflict": ["CasConflict"],
        "atomic_batch_conflict": ["CasConflict"],
    }


# ---------------------------------------------------------------------
# Overload: the interpreted answers equal the armed native frames
# ---------------------------------------------------------------------


def test_interpreted_overload_answers_equal_the_armed_frames(tmp_path):
    """With the C plane off, the interpreted path answers a shed data
    op and a dead-on-arrival one with exactly the frames
    ``install_native_overload_responses`` arms the C plane with, in
    both packages, and the two packages arm the same bytes."""

    async def main(pkg):
        m = PKGS[pkg]
        node = await Node(pkg, node_config(pkg, str(tmp_path / pkg))).start()
        try:
            shard = node.shards[0]
            armed = []
            shard.dataplane = type("Armed", (), {
                "set_overload_responses":
                    staticmethod(lambda *frames: armed.extend(frames))})()
            m.db.install_native_overload_responses(shard)
            shard.dataplane = None
            port = node.config.port
            await exchange(port, [{"type": "create_collection",
                                   "name": "c"}])
            (doa,), _ = await exchange(port, [_set("k", 1, deadline_ms=1)])
            shard.qos.should_shed = lambda cls: True
            (shed,), _ = await exchange(port, [_set("k", 1)])
            (admin,), _ = await exchange(port, [{"type": "get_collection",
                                                 "name": "c"}])
            del shard.qos.should_shed
            return armed, m.db._frame_response(shed), m.db._frame_response(
                doa), admin
        finally:
            await node.stop()

    got = {pkg: run(main(pkg)) for pkg in ("ref", "port")}
    for pkg, (armed, shed, doa, admin) in got.items():
        assert armed == [shed, doa], pkg
        assert decode(admin) == (1, {"replication_factor": 1})
    assert got["ref"] == got["port"]
    assert decode(got["port"][1][4:]) == (
        0, ["Overloaded", "shard n0-0 shedding load"])


# ---------------------------------------------------------------------
# The reference's client against both packages' nodes
# (tests/test_db_server.py's cases)
# ---------------------------------------------------------------------


async def _client(node):
    return await DbeelClient.from_seed_nodes([node.db_address])


async def _collection_crud_and_errors(pkg, d):
    node = await Node(pkg, node_config(pkg, d)).start()
    try:
        client = await _client(node)
        await client.create_collection("users")
        with pytest.raises(jerrors.CollectionAlreadyExists):
            await client.create_collection("users")
        await client.drop_collection("users")
        with pytest.raises(jerrors.CollectionNotFound):
            await client.collection("users").get("niels")
        with pytest.raises(jerrors.CollectionNotFound):
            await client.drop_collection("users")
    finally:
        await node.stop()


async def _set_get_delete(pkg, d):
    node = await Node(pkg, node_config(pkg, d)).start()
    try:
        client = await _client(node)
        col = await client.create_collection("docs")
        await col.set("key", {"name": "tony", "age": 42})
        assert await col.get("key") == {"name": "tony", "age": 42}
        await col.set("key", [1, 2, 3])
        assert await col.get("key") == [1, 2, 3]
        with pytest.raises(jerrors.KeyNotFound):
            await col.get("missing")
        await col.delete("key")
        with pytest.raises(jerrors.KeyNotFound):
            await col.get("key")
    finally:
        await node.stop()


async def _persistence_across_restart(pkg, d):
    cfg = node_config(pkg, d)
    node = await Node(pkg, cfg).start()
    try:
        col = await (await _client(node)).create_collection("docs")
        for i in range(100):
            await col.set(f"key{i}", {"i": i})
    finally:
        await node.stop()
    node = await Node(pkg, cfg).start()
    try:
        col = (await _client(node)).collection("docs")
        for i in range(100):
            assert await col.get(f"key{i}") == {"i": i}
    finally:
        await node.stop()


async def _multi_collection_isolation(pkg, d):
    node = await Node(pkg, node_config(pkg, d)).start()
    try:
        client = await _client(node)
        a = await client.create_collection("a")
        b = await client.create_collection("b")
        await a.set("k", "from-a")
        await b.set("k", "from-b")
        assert await a.get("k") == "from-a"
        assert await b.get("k") == "from-b"
        await a.delete("k")
        with pytest.raises(jerrors.KeyNotFound):
            await a.get("k")
        assert await b.get("k") == "from-b"
    finally:
        await node.stop()


async def _multi_shard_routing(pkg, d):
    node = await Node(pkg, node_config(pkg, d), n_shards=2).start()
    try:
        col = await (await _client(node)).create_collection("docs")
        for i in range(64):
            await col.set(f"key{i}", i)
        for i in range(64):
            assert await col.get(f"key{i}") == i
        held = [len(s.collections["docs"].tree._active) for s in node.shards]
        assert all(held) and sum(held) == 64
    finally:
        await node.stop()


async def _get_stats(pkg, d):
    node = await Node(pkg, node_config(pkg, d)).start()
    try:
        client = await _client(node)
        col = await client.create_collection("s")
        await col.set("k", 1)
        raw = await client._send_to(*node.db_address, {"type": "get_stats"})
        stats = msgpack.unpackb(raw, raw=False)
        assert stats["shard"] == "n0-0"
        assert stats["collections"]["s"]["memtable_entries"] == 1
        # The port names its merge (the heap has no device).
        assert stats["collections"]["s"].get("strategy") == (
            "heap" if pkg == "port" else None)
    finally:
        await node.stop()


async def _collection_discovery_after_restart(pkg, d):
    cfg = node_config(pkg, d)
    node = await Node(pkg, cfg).start()
    try:
        await (await _client(node)).create_collection("rediscovered")
    finally:
        await node.stop()
    node = await Node(pkg, cfg).start()
    try:
        meta = await (await _client(node)).get_cluster_metadata()
        assert ("rediscovered", 1) in meta.collections
    finally:
        await node.stop()


CLIENT_CASES = {f.__name__[1:]: f for f in (
    _collection_crud_and_errors, _set_get_delete,
    _persistence_across_restart, _multi_collection_isolation,
    _multi_shard_routing, _get_stats, _collection_discovery_after_restart)}


@pytest.mark.parametrize("pkg", ["ref", "port"])
@pytest.mark.parametrize("case", list(CLIENT_CASES))
def test_reference_client(tmp_path, case, pkg):
    run(CLIENT_CASES[case](pkg, str(tmp_path / "db")))


# ---------------------------------------------------------------------
# RF 3: three nodes of each package, the same operations
# ---------------------------------------------------------------------


def _same_arc_keys(shard, n, prefix):
    """``n`` string keys whose hashes fall on one arc of ``shard``'s
    ring (an atomic batch must stay on one arc)."""
    from dbeel_tpu.utils.murmur import hash_bytes

    tokens = sorted(s.hash for s in shard.shards)

    def arc(key):
        h = hash_bytes(msgpack.packb(key, use_bin_type=True))
        return sum(t < h for t in tokens) % len(tokens)

    keys = [f"{prefix}{i}" for i in range(64)]
    first = arc(keys[0])
    return [k for k in keys if arc(k) == first][:n]


async def _outcome(coro):
    """A client call's value, or its error kind."""
    try:
        return ("ok", await coro)
    except jerrors.DbeelError as e:
        return ("err", type(e).__name__)


async def _rf3_ops(pkg, d):
    m = PKGS[pkg]
    flow = FLOW[pkg]
    cfg0 = node_config(pkg, os.path.join(d, "n0"), name="n0")
    nodes = [await Node(pkg, cfg0).start()]
    try:
        for i in (1, 2):
            alive = nodes[0].shards[0].flow.subscribe(
                flow.ALIVE_NODE_GOSSIP)
            nodes.append(await Node(pkg, node_config(
                pkg, os.path.join(d, f"n{i}"), name=f"n{i}",
                extra=("--seed-nodes", nodes[0].seed))).start())
            await asyncio.wait_for(alive, 10)
        client = await _client(nodes[0])
        created = [n.shards[0].flow.subscribe(flow.COLLECTION_CREATED)
                   for n in nodes]
        col = await client.create_collection("r", replication_factor=3)
        await asyncio.wait_for(asyncio.gather(*created), 10)
        out = []
        for c in (1, 2, 3):
            level = Consistency.fixed(c)
            out.append(await _outcome(col.set(f"k{c}", {"c": c},
                                              consistency=level)))
            out.append(await _outcome(col.get(f"k{c}", consistency=level)))
        out.append(await _outcome(col.get("k1",
                                          consistency=Consistency.QUORUM)))
        out.append(await _outcome(col.get("nope",
                                          consistency=Consistency.ALL)))
        # A digest read: a converged quorum get never runs the
        # full-entry merge.
        merges = []
        real = m.db._merge_quorum_get

        def spy(*a, **kw):
            merges.append(1)
            return real(*a, **kw)

        m.db._merge_quorum_get = spy
        try:
            out.append(await _outcome(col.get(
                "k3", consistency=Consistency.ALL)))
            out.append(("digest merges", len(merges)))
            # Read repair: node 2's replica misses a newer write that
            # nodes 0 and 1 hold; the quorum read answers the newest
            # value, runs the full merge and repairs node 2.
            key = msgpack.packb("k2", use_bin_type=True)
            v2 = msgpack.packb("v2", use_bin_type=True)
            trees = [n.shards[0].collections["r"].tree for n in nodes]
            newer = (await trees[0].get_entry(key))[1] + 1_000_000
            for tree in trees[:2]:
                await tree.set_with_timestamp(key, v2, newer)
            out.append(await _outcome(col.get(
                "k2", consistency=Consistency.ALL)))
            out.append(("full merges", len(merges) > 0))
        finally:
            m.db._merge_quorum_get = real
        for _ in range(100):
            if await trees[2].get_entry(key) == (v2, newer):
                break
            await asyncio.sleep(0.05)
        out.append(("repaired", await trees[2].get_entry(key) == (
            v2, newer)))
        # CAS: a conflict, then the expectation that holds.
        out.append(await _outcome(col.cas("k1", "x", expect_value={"c": 9})))
        ok = await _outcome(col.cas("k1", "x", expect_value={"c": 1}))
        out.append((ok[0], isinstance(ok[1], int)))
        out.append(await _outcome(col.get("k1", consistency=Consistency.ALL)))
        # An atomic batch on one arc, its conflict, and one across arcs.
        a, b = _same_arc_keys(nodes[0].shards[0], 2, "a")
        ok = await _outcome(col.atomic_batch(
            [{"key": a, "value": 1}, {"key": b, "value": 2,
                                      "expect_absent": True}]))
        out.append((ok[0], isinstance(ok[1], int)))
        out.append(await _outcome(col.atomic_batch(
            [{"key": a, "value": 3, "expect_value": 2}])))
        out.append(await _outcome(col.get(b, consistency=Consistency.ALL)))
        out.append(await _outcome(col.atomic_batch(
            [{"key": f"x{i}", "value": i} for i in range(16)])))
        return out
    finally:
        for n in reversed(nodes):
            await n.stop()


def test_rf3_answers_equal(tmp_path):
    """Quorum sets and gets at each consistency level, a digest read,
    read repair, a CAS conflict and an atomic batch give the same
    answers and error kinds on three port nodes as on three reference
    nodes."""
    got = {pkg: run(_rf3_ops(pkg, str(tmp_path / pkg)))
           for pkg in ("ref", "port")}
    assert got["ref"] == got["port"]
    assert got["port"] == [
        ("ok", None), ("ok", {"c": 1}), ("ok", None), ("ok", {"c": 2}),
        ("ok", None), ("ok", {"c": 3}), ("ok", {"c": 1}),
        ("err", "KeyNotFound"), ("ok", {"c": 3}), ("digest merges", 0),
        ("ok", "v2"), ("full merges", True), ("repaired", True),
        ("err", "CasConflict"), ("ok", True), ("ok", "x"), ("ok", True),
        ("err", "CasConflict"), ("ok", 2), ("err", "BadFieldType")]
